"""Math-answer grading: boxed extraction, normalization, equivalence.

A copy of `nanorlhf_tpu/rewards/math_grader.py` (its subprocess reaping
and forkserver preload name the port's modules).

Fresh implementation of the capability the reference gets from its vendored
DeepSeek/Qwen toolkits (the reference's `examples/r1-v0/utils/
{toolkit_for_MATH,eval}/**`) and the r1 launcher's graders
(`examples/r1-v0/grpo_r1.py:179-224`):

- `get_boxed`: brace-matched \\boxed{...} extraction;
- `normalize_math_answer`: MATH-style latex normalization;
- `math_answers_equal`: string → numeric → sympy-symbolic equivalence ladder;
- `call_with_timeout`: run a grader in a killable subprocess so adversarial
  expressions (e.g. 2^(2^100000)) cannot stall training — the reference's
  timeout-subprocess pattern, host-side next to the training loop.

Everything here is pure Python/sympy on the host; nothing enters the
compiled graph.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import re

# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def get_boxed(text: str) -> str:
    """Contents of the first \\boxed{...}, with nested braces matched.

    Returns "" when absent — callers treat that as wrong
    (`grpo_r1.py:194-213,216-218`). Whitespace stripped like the reference.
    """
    pos = text.find("boxed{")
    if pos == -1:
        return ""
    body = text[pos + len("boxed{"):]
    depth = 1
    for i, ch in enumerate(body):
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return body[:i].replace(" ", "")
    return ""  # unbalanced braces


# ---------------------------------------------------------------------------
# normalization (MATH-style latex surface cleanup)
# ---------------------------------------------------------------------------

_TEXT_CMDS = ("\\text", "\\mbox", "\\textbf", "\\mathrm", "\\mathbf")


def _strip_cmd_wrapper(s: str, cmd: str) -> str:
    """Replace cmd{X} with X (single level, repeatedly)."""
    while True:
        pos = s.find(cmd + "{")
        if pos == -1:
            return s
        depth, start = 1, pos + len(cmd) + 1
        for i in range(start, len(s)):
            if s[i] == "{":
                depth += 1
            elif s[i] == "}":
                depth -= 1
                if depth == 0:
                    s = s[:pos] + s[start:i] + s[i + 1:]
                    break
        else:
            return s


def normalize_math_answer(ans: str) -> str:
    """Canonicalize a latex answer string for surface comparison."""
    s = ans.strip()
    # outer $ ... $ / \( ... \)
    s = s.strip("$")
    s = s.replace("\\(", "").replace("\\)", "").replace("\\[", "").replace("\\]", "")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\!", "").replace("\\,", "").replace("\\;", "").replace("\\:", "")
    s = s.replace("\\$", "").replace("\\%", "").replace("%", "")
    # trailing units: "5\text{ cm}" / "12 \text{ cm}^2" -> "5" / "12" (the
    # MATH-toolkit remove-right-units behavior). A PURE text answer
    # ("\text{east}") has nothing before the block and is left for the
    # wrapper stripping below.
    m = re.match(r"^(.*\S)\s*\\text\{[^{}]*\}(\s*\^\{?\d+\}?)?\s*$", s)
    if m and m.group(1).strip():
        s = m.group(1)
    for cmd in _TEXT_CMDS:
        s = _strip_cmd_wrapper(s, cmd)
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\cdot", "*").replace("\\times", "*")
    # \tfrac/\dfrac -> \frac
    s = s.replace("\\tfrac", "\\frac").replace("\\dfrac", "\\frac")
    # \frac ab / \frac{a}b / \frac a{b} -> \frac{a}{b}
    s = re.sub(r"\\frac\s*([0-9a-zA-Z])\s*([0-9a-zA-Z])", r"\\frac{\1}{\2}", s)
    s = re.sub(r"\\frac\{([^{}]*)\}\s*([0-9a-zA-Z])", r"\\frac{\1}{\2}", s)
    s = re.sub(r"\\frac\s*([0-9a-zA-Z])\s*\{", r"\\frac{\1}{", s)
    # \sqrt x -> \sqrt{x}
    s = re.sub(r"\\sqrt\s*([0-9a-zA-Z])", r"\\sqrt{\1}", s)
    # drop trailing units-ish words after a number, thousands separators
    s = s.replace(",\\!", "").replace("{,}", "")
    s = re.sub(r"(?<=\d),(?=\d{3}\b)", "", s)
    # leading "x=" / "x \in" style assignment prefixes
    s = re.sub(r"^[a-zA-Z]\s*=\s*", "", s)
    s = re.sub(r"^[a-zA-Z]\s*\\in\s*", "", s)
    # 0.5 -> .5 canonicalization (match MATH convention: strip leading 0)
    s = re.sub(r"(?<![\d.])0\.(\d)", r".\1", s)
    s = s.replace(" ", "")
    # trailing period
    s = s.rstrip(".")
    return s


# ---------------------------------------------------------------------------
# equivalence ladder
# ---------------------------------------------------------------------------


def _latex_to_sympy_str(s: str) -> str:
    """Light latex → sympy-parsable conversion for common answer shapes."""
    out = s
    # mixed numbers first: [-]N\frac{a}{b} means ±(N + a/b) — the sign
    # applies to the whole mixed number, so -1\frac{1}{2} = -1.5, not -0.5
    mixed = re.compile(r"(-?)(\d+)\\frac\{([^{}]*)\}\{([^{}]*)\}")
    frac = re.compile(r"\\frac\{([^{}]*)\}\{([^{}]*)\}")
    sqrt = re.compile(r"\\sqrt\{([^{}]*)\}")
    # one FIXPOINT over all three: each pattern only matches brace-free
    # arguments, so nesting (\frac{\sqrt{3}}{3}, \sqrt{\frac{1}{2}}) must
    # convert innermost-first across patterns — separate per-pattern loops
    # left nested forms half-converted into sympy garbage
    while True:
        prev = out
        out = mixed.sub(r"\1((\2)+((\3)/(\4)))", out)
        out = frac.sub(r"((\1)/(\2))", out)
        out = sqrt.sub(r"sqrt(\1)", out)
        if out == prev:
            break
    out = out.replace("\\pi", "pi").replace("\\infty", "oo")
    out = out.replace("^", "**")
    out = out.replace("{", "(").replace("}", ")")
    out = out.replace("\\", "")
    return out


def _try_float(s: str):
    try:
        return float(s)
    except (ValueError, TypeError):
        return None


def _numeric_equal(a: str, b: str, tol: float = 1e-6) -> bool | None:
    fa, fb = _try_float(a), _try_float(b)
    if fa is None or fb is None:
        return None
    return abs(fa - fb) <= tol * max(1.0, abs(fa), abs(fb))


def _parse_sympy(s: str):
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    transforms = standard_transformations + (implicit_multiplication_application,)
    return parse_expr(_latex_to_sympy_str(s), transformations=transforms)


def _sympy_equal(a: str, b: str) -> bool:
    """Symbolic equality via sympy; exceptions mean 'not provably equal'.

    Falls back to numeric evaluation with the reference's closeness
    (`latex_answer_check.symbolic_equal:70-74` uses rel_tol 1e-3;
    `eval_utils.math_equal` abs_tol 1e-3) so `3.1416 == \\pi` grades True.
    """
    try:
        import sympy

        ea = _parse_sympy(a)
        eb = _parse_sympy(b)
        if sympy.simplify(ea - eb) == 0:
            return True
        try:
            import math

            return math.isclose(float(sympy.N(ea)), float(sympy.N(eb)),
                                rel_tol=1e-3, abs_tol=1e-3)
        except Exception:
            return False
    except Exception:
        return False


def _expand_pm(s: str) -> list[str]:
    """a\\pm b → [a+b, a-b] (first \\pm only; recursion covers multiples)."""
    if "\\pm" not in s:
        return [s]
    plus = s.replace("\\pm", "+", 1)
    minus = s.replace("\\pm", "-", 1)
    return _expand_pm(plus) + _expand_pm(minus)


def _branch_set(s: str) -> list[str]:
    """Branches of a \\pm expression, or the comma-separated members of an
    explicit pair/set written as {a,b} / (a,b) / a,b."""
    if "\\pm" in s:
        return _expand_pm(s)
    body = s
    if len(body) >= 2 and (body[0], body[-1]) in {("{", "}"), ("(", ")")}:
        body = body[1:-1]
    if "," in body:
        return [p for p in body.split(",") if p]
    return [s]


def _light_clean(s: str) -> str:
    """Structural cleanup only: strip $, spaces, \\left/\\right — keep
    brackets/commas/relations intact for the structured comparisons."""
    s = s.strip().strip("$")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\!", "").replace("\\,", "").replace("\\;", "")
    return s.replace(" ", "")


def _digit_value(raw: str):
    """float value of a plain-number string; '%'-suffixed values divide by
    100 (`eval_utils.parse_digits` behavior). None when not a number."""
    s = _light_clean(raw)
    s = re.sub(r"(?<=\d),(?=\d{3}\b)", "", s)
    pct = False
    for suffix in ("\\%", "%"):
        if s.endswith(suffix):
            s, pct = s[: -len(suffix)], True
            break
    v = _try_float(s)
    if v is None:
        return None
    return v / 100.0 if pct else v


def _digits_equal(
    pred_raw: str, gt_raw: str, percent_variants: bool = False
) -> bool | None:
    """Numeric comparison with abs_tol 1e-3. With ``percent_variants``, pred
    is also compared against {gt/100, gt*100} (`eval_utils.math_equal:195-214`
    — the reference applies this leniency in its OFFLINE EVAL toolkit only).
    Without it, the x100 variants are accepted only when either side carries
    an explicit '%': a LIVE TRAINING reward that accepted '0.5' for '50'
    unconditionally would be a reward-hacking surface the reference's
    training-path grader (`grpo_r1.py:216-224`) does not have."""
    import math

    pv, gv = _digit_value(pred_raw), _digit_value(gt_raw)
    if pv is None or gv is None:
        return None
    lenient = percent_variants or any(
        "%" in s or "\\%" in s or "percent" in s.lower()
        for s in (pred_raw, gt_raw)
    )
    variants = (gv / 100.0, gv, gv * 100.0) if lenient else (gv,)
    return any(
        math.isclose(pv, g, rel_tol=1e-9, abs_tol=1e-3) for g in variants
    )


_MAT_ENVS = ("pmatrix", "bmatrix")


def _matrix_rows(s: str):
    for env in _MAT_ENVS:
        pre, post = f"\\begin{{{env}}}", f"\\end{{{env}}}"
        for env2 in _MAT_ENVS:  # mixed pmatrix/bmatrix graded alike
            post2 = f"\\end{{{env2}}}"
            if s.startswith(pre) and s.endswith(post2):
                body = s[len(pre): -len(post2)]
                return [
                    row.split("&") for row in body.split("\\\\") if row.strip()
                ]
    return None


_REL_CANON = (("\\leq", "<="), ("\\le", "<="), ("\\geq", ">="), ("\\ge", ">="),
              ("\\lt", "<"), ("\\gt", ">"), ("\\neq", "!="), ("\\ne", "!="))


def _canon_rel(s: str) -> str:
    for latex, op in _REL_CANON:
        s = s.replace(latex, op)
    return s


def _has_rel_op(s: str) -> bool:
    return any(op in s for op in ("<=", ">=", "<", ">"))


def _relational_equal(a: str, b: str) -> bool:
    """x <= 5 vs 5 >= x etc: canonicalize the sympy Relational (variable on
    the left) then require the same operator and a zero lhs-rhs difference."""
    try:
        import sympy

        ea, eb = _parse_sympy(a), _parse_sympy(b)
        if not (isinstance(ea, sympy.core.relational.Relational)
                and isinstance(eb, sympy.core.relational.Relational)):
            return False
        ca, cb = ea.canonical, eb.canonical
        if ca.rel_op != cb.rel_op:
            return False
        return sympy.simplify((ca.lhs - ca.rhs) - (cb.lhs - cb.rhs)) == 0
    except Exception:
        return False


def _inequation_equal(a: str, b: str) -> bool:
    """x != 5 vs 5 != x: the lhs-rhs differences must match up to sign."""
    if a.count("!=") != 1 or b.count("!=") != 1:
        return False
    try:
        import sympy

        al, ar = a.split("!=")
        bl, br = b.split("!=")
        da = _parse_sympy(al) - _parse_sympy(ar)
        db = _parse_sympy(bl) - _parse_sympy(br)
        return bool(
            sympy.simplify(da - db) == 0 or sympy.simplify(da + db) == 0
        )
    except Exception:
        return False


def _equation_equal(a: str, b: str) -> bool | None:
    """Both sides single '=' (`eval_utils.math_equal:255-266`): lhs-rhs must
    match up to global sign; 'x=5' vs '5' (lhs <= 2 chars) compares the rhs."""
    ca, cb = a.count("="), b.count("=")
    if ca == 1 and cb == 1:
        try:
            import sympy

            al, ar = a.split("=")
            bl, br = b.split("=")
            da = _parse_sympy(al) - _parse_sympy(ar)
            db = _parse_sympy(bl) - _parse_sympy(br)
            return bool(
                sympy.simplify(da - db) == 0 or sympy.simplify(da + db) == 0
            )
        except Exception:
            return False
    if ca == 1 and cb == 0:
        lhs, rhs = a.split("=")
        if len(lhs) <= 2:
            return math_answers_equal(rhs, b)
    if cb == 1 and ca == 0:
        lhs, rhs = b.split("=")
        if len(lhs) <= 2:
            return math_answers_equal(a, rhs)
    return None


def _split_top_level(s: str, sep: str = ",") -> list[str]:
    """Split on `sep` only at bracket depth 0 (over (), [], {})."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def math_answers_equal(
    pred: str, gt: str, percent_variants: bool = False
) -> bool:
    """Equivalence ladder, reference-toolkit breadth:
    string → numeric (percent-aware; x100 variants only when a '%' marker
    appears or ``percent_variants`` is set — eval paths pass True for
    `eval_utils.math_equal` parity, training rewards stay strict) →
    \\cup unions → matrices → intervals/tuples → relations/equations →
    normalized → \\pm branches → numeric → sympy symbolic (with
    numeric-closeness fallback).
    No subprocess here — wrap in call_with_timeout for that.
    """
    if pred is None or gt is None:
        return False
    if pred.strip() == gt.strip():
        return True

    # numeric first, on the RAW strings (normalization strips '%', which
    # must influence the value first)
    num = _digits_equal(pred, gt, percent_variants=percent_variants)
    if num is not None:
        return num

    a_s, b_s = _light_clean(pred), _light_clean(gt)
    # set unions FIRST: order-free bipartite coverage of the pieces,
    # matching `eval_script.is_correct:28-33` (which recurses into the list
    # path). Must run before the brace-set branch — "\{1\}\cup\{2\}" both
    # starts with \{ and ends with \}, and treating the whole union as one
    # set mangles its elements.
    if "\\cup" in a_s or "\\cup" in b_s:
        pa, pb = a_s.split("\\cup"), b_s.split("\\cup")
        if len(pa) != len(pb):
            return False
        return all(
            any(math_answers_equal(x, y) for y in pb) for x in pa
        ) and all(
            any(math_answers_equal(x, y) for x in pa) for y in pb
        )
    # finite brace sets \{...\}: order-free symmetric coverage of the
    # TOP-LEVEL elements ({1,2} == {2,1} — FiniteSet semantics; elements
    # may themselves be tuples/intervals, so the comma split is depth-aware)
    if (a_s.startswith("\\{") and a_s.endswith("\\}")
            and b_s.startswith("\\{") and b_s.endswith("\\}")):
        ea = [x for x in _split_top_level(a_s[2:-2]) if x.strip()]
        eb = [x for x in _split_top_level(b_s[2:-2]) if x.strip()]
        return (
            all(any(math_answers_equal(x, y) for y in eb) for x in ea)
            and all(any(math_answers_equal(x, y) for x in ea) for y in eb)
        )
    # matrices: rows by \\\\, columns by &, env type ignored
    # (`eval_utils.math_equal:233-253`)
    ma, mb = _matrix_rows(a_s), _matrix_rows(b_s)
    if ma is not None and mb is not None:
        return len(ma) == len(mb) and all(
            len(ra) == len(rb)
            and all(math_answers_equal(x, y) for x, y in zip(ra, rb))
            for ra, rb in zip(ma, mb)
        )
    # intervals/tuples: elementwise; bracket TYPES are not compared — the
    # reference's regex accepts any ([ ... )] pairing (`eval_utils:225-231`)
    if (
        len(a_s) >= 2 and len(b_s) >= 2
        and a_s[0] in "([" and a_s[-1] in ")]"
        and b_s[0] in "([" and b_s[-1] in ")]"
        and "," in a_s and "," in b_s
    ):
        pa, pb = a_s[1:-1].split(","), b_s[1:-1].split(",")
        if len(pa) == len(pb) and all(
            math_answers_equal(x, y) for x, y in zip(pa, pb)
        ):
            return True
    # relations (<=, <, ...) and single-'=' equations, BEFORE normalization
    # strips assignment prefixes
    ra, rb = _canon_rel(a_s), _canon_rel(b_s)
    # != first: its '=' would otherwise route into the equation branch,
    # where splitting at '=' turns 'x!' into factorial(x)
    if "!=" in ra or "!=" in rb:
        if ("!=" in ra) != ("!=" in rb):
            return False
        return _inequation_equal(ra, rb)
    if _has_rel_op(ra) or _has_rel_op(rb):
        if _has_rel_op(ra) != _has_rel_op(rb):
            return False
        return _relational_equal(ra, rb)
    if "=" in ra or "=" in rb:
        eq = _equation_equal(ra, rb)
        if eq is not None:
            return eq

    a, b = normalize_math_answer(pred), normalize_math_answer(gt)
    if a == b:
        return True
    if not a or not b:
        return False
    # \pm answers: the branch SETS must match symmetrically, and an explicit
    # pair/set on the other side counts as its branches (2\pm 1 == {1, 3})
    if "\\pm" in a or "\\pm" in b:
        ea, eb = _branch_set(a), _branch_set(b)
        return (
            all(any(math_answers_equal(x, y) for y in eb) for x in ea)
            and all(any(math_answers_equal(x, y) for x in ea) for y in eb)
        )
    num = _numeric_equal(a, b)
    if num is not None:
        return num
    return _sympy_equal(a, b)


# ---------------------------------------------------------------------------
# timeout guard
# ---------------------------------------------------------------------------


def _grade_worker(pred, gt, q):
    try:
        q.put(math_answers_equal(pred, gt))
    except Exception:
        q.put(False)


def _ensure_sympy_loaded():
    """Import sympy in the parent once, so forked grader children inherit the
    loaded module instead of paying a multi-second import inside their tiny
    timeout budget (the reference's 0.015 s only works because its parent
    imported the toolkit at module load)."""
    import sympy  # noqa: F401
    import sympy.parsing.sympy_parser  # noqa: F401


_logger = logging.getLogger("nanorlhf_tpu_torch.rewards")
_GRADER_CTX = None


def _grader_context():
    """Grader subprocess context, created once.

    Default: `fork` with the parent's preloaded sympy — fast (<1 ms spawn)
    but forks the (threaded) trainer process; a wedged child is bounded by
    join+terminate and LOGGED (see call_with_timeout), so silent reward
    corruption is observable.

    `NANORLHF_GRADER_START_METHOD=forkserver` opts into forking from a
    single-threaded server instead — eliminates the fork-under-threads
    deadlock class entirely, at the price of spawn start-method semantics:
    children re-import `__main__` (grading funcs defined in a REPL/stdin
    fail, and launcher modules must be import-safe) and each child pays the
    server round-trip.
    """
    global _GRADER_CTX
    if _GRADER_CTX is None:
        method = os.environ.get("NANORLHF_GRADER_START_METHOD", "fork")
        if method == "forkserver":
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload(
                ["sympy", "sympy.parsing.sympy_parser",
                 "nanorlhf_tpu_torch.rewards.math_grader"]
            )
            _GRADER_CTX = ctx
        else:
            _ensure_sympy_loaded()
            _GRADER_CTX = multiprocessing.get_context("fork")
    return _GRADER_CTX


def call_with_timeout(func, *args, timeout: float = 0.5):
    """Run func(*args, queue) in a subprocess; False on timeout or exception.

    Same contract as the reference's guard (`grpo_r1.py:179-192`): the child
    receives an extra Queue argument and must put its result there. join +
    terminate bounds the wait even if the child wedges. Every
    timeout/terminate/no-result path is LOGGED — a graded-False caused by
    infrastructure rather than a wrong answer must be observable, since it
    corrupts the reward signal silently otherwise.
    """
    global _GRADER_CTX
    ctx = _grader_context()
    q = ctx.Queue()
    try:
        p = ctx.Process(target=func, args=args + (q,))
        p.start()
    except Exception as e:
        # e.g. unpicklable func under forkserver: fall back to plain fork
        # PERSISTENTLY — re-attempting a doomed forkserver spawn on every one
        # of thousands of per-rollout grades would pay the failure each time
        _logger.warning("grader forkserver spawn failed (%s); using fork", e)
        _ensure_sympy_loaded()
        ctx = multiprocessing.get_context("fork")
        _GRADER_CTX = ctx
        q = ctx.Queue()
        p = ctx.Process(target=func, args=args + (q,))
        p.start()
    p.join(timeout)
    if p.is_alive():
        from nanorlhf_tpu_torch.resilience.procs import reap_process

        reap_process(p)
        _logger.warning(
            "grader timed out after %.3fs — graded False (func=%s)",
            timeout, getattr(func, "__name__", func),
        )
        return False
    try:
        return q.get(timeout=0.1)
    except Exception:
        _logger.warning(
            "grader child exited without a result (rc=%s) — graded False",
            p.exitcode,
        )
        return False


def is_correct(pred: str, gt: str, timeout: float = 0.5, use_subprocess: bool = True) -> bool:
    """Full grader: exact match fast path, then timeout-guarded equivalence.

    `iscorrect` parity (`grpo_r1.py:216-224`). `use_subprocess=False` runs
    in-process (tests / trusted inputs; much faster on 1-core hosts).
    """
    if not pred:
        return False
    if pred.strip() == gt.strip():
        return True
    if use_subprocess:
        return bool(call_with_timeout(_grade_worker, pred, gt, timeout=timeout))
    return math_answers_equal(pred, gt)
