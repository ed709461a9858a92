"""The fused hidden→logprob op's plain version (ops/fused_logprob.py — what
the port runs for CPU tensors and holds the Hopper kernel against) against
the JAX Pallas kernel in interpret mode, the JAX lax chunk scan and the
full-logits oracle, in f32; and its backward (the chunked recompute) against
`jax.vjp` of the JAX op."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops import fused_logprob as tf

# the module, not the function nanorlhf_tpu.ops re-exports under its name
jf = importlib.import_module("nanorlhf_tpu.ops.fused_logprob")

torch.set_num_threads(1)

ATOL = 1e-5

CASES = {
    # name: (rows, D, V) — V not a multiple of the 512-wide Pallas vocab block
    "ragged_vocab": (37, 32, 1000),
    "small": (16, 16, 130),
}


def _inputs(rng, R, D, V, transposed):
    h = rng.standard_normal((R, D)).astype(np.float32)
    w = (rng.standard_normal((V, D) if transposed else (D, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, R).astype(np.int32)
    return h, w, labels


@pytest.mark.parametrize("with_entropy", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("temp", [1.0, 0.7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_lax_and_oracle(case, temp, transposed,
                                                 with_entropy, rng):
    R, D, V = CASES[case]
    h, w, labels = _inputs(rng, R, D, V, transposed)
    kw = dict(with_entropy=with_entropy, transposed=transposed)
    got = tf.fused_logprob(torch.as_tensor(h), torch.as_tensor(w),
                           torch.as_tensor(labels), temp, chunk=9, **kw)
    got = got if with_entropy else (got,)
    jargs = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), temp)
    lp, ent = jf._pallas_forward(*jargs, interpret=True, transposed=transposed,
                                 with_entropy=with_entropy)
    lax = jf.fused_logprob(*jargs, chunk=9, impl="lax", **kw)
    oracle = jf.fused_logprob_reference(*jargs, **kw)
    lax = lax if with_entropy else (lax,)
    oracle = oracle if with_entropy else (oracle,)
    for i, want in enumerate((lp, ent)[:len(got)]):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(lax[i]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(oracle[i]), atol=ATOL, rtol=0)
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


@pytest.mark.parametrize("temp", [1.0, 0.5])
def test_margin_and_reference_match_jax(temp, rng):
    h, w, labels = _inputs(rng, 24, 16, 300, False)
    got = tf.fused_logprob(torch.as_tensor(h), torch.as_tensor(w),
                           torch.as_tensor(labels), temp, chunk=7,
                           with_entropy=True, with_margin=True)
    want = jf.fused_logprob(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                            temp, chunk=7, impl="lax", with_entropy=True,
                            with_margin=True)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=ATOL, rtol=0)
    ref = tf.fused_logprob_reference(torch.as_tensor(h), torch.as_tensor(w),
                                     torch.as_tensor(labels), temp,
                                     with_entropy=True, with_margin=True)
    for g, x in zip(ref, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=ATOL, rtol=0)


def test_leading_shape_and_label_check(rng):
    h, w, labels = _inputs(rng, 12, 16, 64, True)
    got = tf.fused_logprob(torch.as_tensor(h).reshape(3, 4, 16), torch.as_tensor(w),
                           torch.as_tensor(labels).reshape(3, 4), 0.9, transposed=True)
    want = jf.fused_logprob(jnp.asarray(h).reshape(3, 4, 16), jnp.asarray(w),
                            jnp.asarray(labels).reshape(3, 4), 0.9, transposed=True)
    assert tuple(got.shape) == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tf.fused_logprob(torch.as_tensor(h), torch.as_tensor(w),
                         torch.as_tensor(labels)[:5], transposed=True)
    with pytest.raises(ValueError):
        tf.fused_logprob(torch.as_tensor(h), torch.as_tensor(w),
                         torch.as_tensor(labels), impl="triton", transposed=True)
    with pytest.raises(ValueError):  # the kernel runs on CUDA tensors only
        tf.fused_logprob_kernel(torch.as_tensor(h), torch.as_tensor(w),
                                torch.as_tensor(labels), transposed=True)


@pytest.mark.parametrize("impl,margin,is_cuda,route", [
    ("auto", False, False, "chunked"), ("pallas", False, False, "chunked"),
    ("auto", False, True, "kernel"), ("pallas", False, True, "kernel"),
    ("lax", False, True, "chunked"), ("lax", True, True, "chunked"),
    ("auto", True, False, "chunked"), ("auto", True, True, None),
    ("pallas", True, True, None),
])
def test_routing_never_swaps_the_kernel_for_a_cuda_tensor(impl, margin, is_cuda, route):
    """CPU tensors take the plain version; CUDA tensors take the kernel
    unless the caller asks for "lax", and the margin (which the kernel does
    not compute) raises there instead of quietly leaving the kernel."""
    if route is None:
        with pytest.raises(NotImplementedError, match="margin"):
            tf._resolve_impl(impl, margin, is_cuda)
    else:
        assert tf._resolve_impl(impl, margin, is_cuda) == route


@pytest.mark.parametrize("V,rows,dtype_bytes",[(151936, 24000, 2), (4096, 10, 4),
                                                (50000, 5000, 2)])
def test_fused_chunk_rows_matches_jax(V, rows, dtype_bytes):
    assert tf.fused_chunk_rows(V, rows, dtype_bytes) == jf.fused_chunk_rows(
        V, rows, dtype_bytes)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("temp", [1.0, 0.7])
@pytest.mark.parametrize("with_entropy", [False, True])
def test_backward_matches_jax_vjp(transposed, temp, with_entropy, rng):
    """dh [R, D] and dW (in the weight's own orientation) of the chunked
    recompute vs `jax.vjp` of the JAX op's lax path, on 37 rows in chunks
    of 8 (a ragged last chunk of 5). The entropy output carries no
    gradient in either package."""
    R, D, V = 37, 16, 300
    h, w, labels = _inputs(rng, R, D, V, transposed)
    g = rng.standard_normal(R).astype(np.float32)
    th = torch.as_tensor(h).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    out = tf.fused_logprob(th, tw, torch.as_tensor(labels), temp, chunk=8,
                           with_entropy=with_entropy, transposed=transposed)
    lp = out[0] if with_entropy else out
    dh, dw = torch.autograd.grad(lp, (th, tw), torch.as_tensor(g))

    def f(h_, w_):
        o = jf.fused_logprob(h_, w_, jnp.asarray(labels), temp, chunk=8, impl="lax",
                             with_entropy=with_entropy, transposed=transposed)
        return o[0] if with_entropy else o

    _, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w))
    jdh, jdw = vjp(jnp.asarray(g))
    assert tuple(dw.shape) == w.shape
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=ATOL, rtol=1e-5)


def test_backward_skips_dw_for_a_frozen_weight(rng, monkeypatch):
    """With a weight that needs no gradient only dh is computed, and it is
    the same dh."""
    h, w, labels = _inputs(rng, 20, 16, 100, True)
    th = torch.as_tensor(h).requires_grad_()
    lab = torch.as_tensor(labels)
    frozen = torch.autograd.grad(
        tf.fused_logprob(th, torch.as_tensor(w), lab, 0.9, chunk=6, transposed=True).sum(),
        th)[0]
    tw = torch.as_tensor(w).requires_grad_()
    both = torch.autograd.grad(
        tf.fused_logprob(th, tw, lab, 0.9, chunk=6, transposed=True).sum(), (th, tw))
    torch.testing.assert_close(frozen, both[0], atol=0, rtol=0)
    calls = []
    real = tf._chunked_backward

    def spy(*args, need_dw, **kw):
        calls.append(need_dw)
        return real(*args, need_dw=need_dw, **kw)

    monkeypatch.setattr(tf, "_chunked_backward", spy)
    torch.autograd.grad(tf.fused_logprob(th, torch.as_tensor(w), lab, 0.9,
                                         transposed=True).sum(), th)
    assert calls == [False]


@pytest.mark.parametrize("shape,chunk,budget", [
    ((3, 11, 97), 5, None),        # several time blocks, a ragged last one
    ((2, 7, 130), None, 4096),     # the row budget from fused_chunk_rows
    ((9, 64), 4, None),            # no batch axis
    ((2, 5, 40), 1000, None),      # one block
])
@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_chunked_entropy_matches_jax_and_full_entropy(shape, chunk, budget, temp, rng):
    """The naive update branch's entropy stat: time-axis blocks of the
    logits against JAX's `chunked_entropy` and against the entropy of the
    whole f32 tensor at once (f32: 1e-5); no gradient; a bf16 input gives
    the entropy of its f32 values."""
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    got = tf.chunked_entropy(torch.as_tensor(logits).requires_grad_(True), temp,
                             chunk=chunk, bytes_budget=budget)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1]
    assert not got.requires_grad
    want = jf.chunked_entropy(jnp.asarray(logits), temp, chunk=chunk, bytes_budget=budget)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    full = tf.entropy_from_logits(torch.as_tensor(logits) / temp)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL, rtol=0)
    bf16 = torch.as_tensor(logits).to(torch.bfloat16)
    np.testing.assert_allclose(
        tf.chunked_entropy(bf16, temp, chunk=chunk, bytes_budget=budget).numpy(),
        tf.entropy_from_logits(bf16.float() / temp).numpy(), atol=ATOL, rtol=0)
