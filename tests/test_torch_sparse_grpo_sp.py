"""Sparse GRPO with sequence parallelism: the port's `SparseGRPOTrainer` at
sp = 2 on spawned gloo ranks against sp = 1 in the test's process, on the
same seed (JAX's `tests/test_sparse_grpo_sp.py`: identical rollouts, the
LoRA leaves within 5e-3 / 2e-3 after both updates, the loss and the
rollout KL within 1e-3), with the ring under remat; and the bucket widths
rounded up to sp multiples as JAX's `_sp_round_len` rounds them."""

import numpy as np
import pytest
import torch

import _torch_sp_ranks as R
from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.trainer.sparse_grpo import SparseGRPOTrainer as JaxSparseGRPOTrainer

torch.set_num_threads(1)


def _spec(**over):
    cfg = dict(response_length=8, temperature=1.0, sample_n=2, kl_coef=0.05,
               total_episodes=4, per_device_train_batch_size=2,
               gradient_accumulation_steps=1, num_mini_batches=1, learning_rate=1e-3,
               lora_r=4, lora_alpha=8, gradient_checkpointing=False, eval_steps=0)
    cfg.update(over)
    return dict(sparse=True, updates=2, cfg=cfg)


SPECS = {"plain": _spec(), "remat": _spec(gradient_checkpointing=True)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("sparse_sp")
    specs = {n: dict(s, out=str(root / n)) for n, s in SPECS.items()}
    ranks = R.shared_spawn(tmp_path_factory, "sparse_sp", R.run_cases, 2,
                           ([("train", specs[n]) for n in sorted(specs)],))
    return {n: ([r[i] for r in ranks], R.train_once(dict(specs[n], out=str(root / "ctl")), 1))
            for i, n in enumerate(sorted(specs))}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_sp2_matches_single_device(trained, name):
    ranks, ctl = trained[name]
    assert ctl["state"]["global_step"] == 2
    rows = [r for r in ctl["rows"] if "sparse/kept_frac" in r]
    assert rows
    for got in ranks:
        assert "error" not in got, got.get("error")
        assert got["state"] == ctl["state"]
        for k, want in ctl["leaves"].items():
            np.testing.assert_allclose(got["leaves"][k], want, rtol=5e-3, atol=2e-3,
                                       err_msg=k)
        sp_rows = [r for r in got["rows"] if "sparse/kept_frac" in r]
        assert len(sp_rows) == len(rows)
        for a, b in zip(sp_rows, rows):
            assert abs(a["loss/policy_avg_new"] - b["loss/policy_avg_new"]) < 1e-3
            assert abs(a["objective/kl_rollout_old"] - b["objective/kl_rollout_old"]) < 1e-3
            assert a["sparse/kept_frac"] == b["sparse/kept_frac"]
            assert a["sp/size"] == 2.0 and a["sp/hops"] > 0


@pytest.mark.parametrize("blen,cap,want", [(31, 64, 32), (32, 64, 32), (63, 63, None),
                                           (33, 34, 34), (1, 2, 2)])
def test_bucket_width_rounds_to_sp_multiples_as_jax(blen, cap, want):
    """`_sp_round_len` against JAX's on a stand-in trainer at sp = 2: the
    width rounded up to an sp multiple, capped at the physical width, and
    JAX's ValueError when the cap itself does not divide."""
    from types import SimpleNamespace

    from nanorlhf_tpu_torch.trainer.sparse_grpo import SparseGRPOTrainer

    port = SimpleNamespace(mesh=SimpleNamespace(sp=2))
    jax_tr = SimpleNamespace(mesh=SimpleNamespace(shape={"sp": 2}))
    if want is None:
        with pytest.raises(ValueError, match="not divisible by sp=2"):
            SparseGRPOTrainer._sp_round_len(port, blen, cap)
        with pytest.raises(ValueError, match="not divisible by sp=2"):
            JaxSparseGRPOTrainer._sp_round_len(jax_tr, blen, cap)
        return
    assert SparseGRPOTrainer._sp_round_len(port, blen, cap) == want
    assert JaxSparseGRPOTrainer._sp_round_len(jax_tr, blen, cap) == want
