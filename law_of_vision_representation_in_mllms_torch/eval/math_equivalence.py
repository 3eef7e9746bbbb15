"""LaTeX math-answer equivalence for OlympiadBench
(`lmms_eval/tasks/olympiadbench/olympiadbench_evals.py:23-354`).

A compact sympy-backed reimplementation of the reference's
OlympiadBenchEvaluator.judge: extract the \\boxed{} payload, split
multi-answers on top-level commas, expand ±, then try (in order) exact
string match, numeric comparison within the per-problem precision
(including the reference's percentage leniency), and symbolic
equivalence via sympify over a light LaTeX->python translation
(`\\frac`/`\\sqrt`/`\\pi`/`\\cdot`/`^`). Equations compare the
difference ratio of their sides like `equation_equal` does. sympy's
antlr LaTeX parser is not available in this environment, so the
translation handles the operator subset olympiad answers actually use.
"""

from __future__ import annotations

import re
from typing import List


def extract_boxed(text: str) -> str:
    """ALL \\boxed{...} payloads (balanced braces), comma-joined — the
    reference concatenates every occurrence so one-answer-per-box
    responses score correctly (`olympiadbench_evals.py:288-321`
    extract_boxed_content); falls back to the raw text when unboxed."""
    payloads = []
    pos = 0
    while True:
        idx = text.find("\\boxed{", pos)
        if idx < 0:
            break
        i = idx + len("\\boxed{")
        depth = 1
        out = []
        while i < len(text) and depth:
            c = text[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    break
            out.append(c)
            i += 1
        payloads.append("".join(out))
        pos = i
    return ",".join(payloads) if payloads else text


def split_top_level(expr: str, sep: str = ",") -> List[str]:
    """Split on separators not nested in (), [], {} (`split_by_comma`)."""
    parts, depth, cur = [], 0, []
    for c in expr:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == sep and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


def expand_pm(items: List[str]) -> List[str]:
    """a\\pm b -> [a+b, a-b] (`trans_plus_minus_sign`)."""
    out = []
    for it in items:
        if "\\pm" in it:
            out.append(it.replace("\\pm", "+"))
            out.append(it.replace("\\pm", "-"))
        else:
            out.append(it)
    return out


_LATEX_SUBS = [
    (re.compile(r"\\frac\s*\{([^{}]+)\}\s*\{([^{}]+)\}"), r"((\1)/(\2))"),
    (re.compile(r"\\frac\s*(\d)\s*(\d)"), r"((\1)/(\2))"),
    (re.compile(r"\\sqrt\s*\{([^{}]+)\}"), r"sqrt(\1)"),
    (re.compile(r"\\sqrt\s*(\d)"), r"sqrt(\1)"),
    (re.compile(r"\\left|\\right"), ""),
    (re.compile(r"\\(?:cdot|times)"), "*"),
    (re.compile(r"\\pi\b"), "(pi)"),
    (re.compile(r"\\infty"), "oo"),
    (re.compile(r"\\(?:mathrm|text|textbf|mathbf)\s*\{([^{}]*)\}"), r"\1"),
    (re.compile(r"\\%|%"), "/100"),
    # degree annotations strip BEFORE '^' becomes '**' (order matters:
    # 45^\circ must reach sympy as 45, not 45**circ)
    (re.compile(r"\\degree|\^\\circ|°"), ""),
    (re.compile(r"\^\s*\{([^{}]+)\}"), r"**(\1)"),
    (re.compile(r"\^"), "**"),
    (re.compile(r"\$|\\,|\\;|\\!|\s"), ""),
]


def latex_to_sympy_str(expr: str) -> str:
    # iterate: nested \frac{\sqrt{3}}{2} resolves over repeated passes
    # (inner macros must translate before the outer \frac's braces become
    # matchable, so the catch-all backslash strip happens only after
    # convergence)
    prev = None
    while prev != expr:
        prev = expr
        for pat, rep in _LATEX_SUBS:
            expr = pat.sub(rep, expr)
    expr = expr.replace("\\", "")   # remaining macros become bare names
    # implicit multiplication: 2pi -> 2*pi, 3sqrt( -> 3*sqrt(
    expr = re.sub(r"(\d)\s*\(", r"\1*(", expr)
    expr = re.sub(r"(\d)([a-zA-Z])", r"\1*\2", expr)
    expr = re.sub(r"\)(\d|[a-zA-Z(])", r")*\1", expr)
    return expr


def _sympify(expr: str):
    import sympy
    return sympy.sympify(latex_to_sympy_str(expr), rational=False)


def _numeric(expr: str):
    try:
        v = _sympify(expr)
        f = float(v.evalf())
        return f
    except Exception:  # noqa: BLE001 — non-numeric expressions
        return None


_INTERVAL_RE = re.compile(
    r"^\s*([\(\[])([^,]+),([^,]+)([\)\]])\s*$")


def _interval_equal(e1: str, e2: str, precision: float) -> bool:
    r"""Interval/tuple equivalence (`interval_equal`, :253-284): same
    bracket kinds, endpoints equal; \cup unions compare part-wise."""
    parts1 = e1.split("\\cup")
    parts2 = e2.split("\\cup")
    if len(parts1) != len(parts2):
        return False
    for p1, p2 in zip(parts1, parts2):
        m1 = _INTERVAL_RE.match(p1.strip())
        m2 = _INTERVAL_RE.match(p2.strip())
        if not (m1 and m2):
            return False
        if m1.group(1) != m2.group(1) or m1.group(4) != m2.group(4):
            return False
        for a, b in ((m1.group(2), m2.group(2)),
                     (m1.group(3), m2.group(3))):
            if not _single_equal(a.strip(), b.strip(), precision):
                return False
    return True


def _single_equal(e1: str, e2: str, precision: float) -> bool:
    """Mirror `is_equal`: exact, numeric-within-precision (with the x100
    / /100 percentage leniency), interval, symbolic, then equation
    comparison."""
    if e1 == e2:
        return True
    precision = max(precision, 1e-8)
    if _INTERVAL_RE.match(e1.strip()) and _INTERVAL_RE.match(e2.strip()):
        return _interval_equal(e1, e2, precision)
    if "\\cup" in e1 or "\\cup" in e2:
        return _interval_equal(e1, e2, precision)
    n1, n2 = _numeric(e1), _numeric(e2)
    if n1 is not None and n2 is not None:
        for cand in (n2, n2 / 100.0, n2 * 100.0):
            if abs(n1 - cand) <= precision * 1.01:
                return True
        return False
    # equations: compare difference ratios of (lhs - rhs)
    if ("=" in e1) and ("=" in e2):
        try:
            import sympy
            l1, r1 = (_sympify(s) for s in e1.split("=", 1))
            l2, r2 = (_sympify(s) for s in e2.split("=", 1))
            d1, d2 = sympy.simplify(l1 - r1), sympy.simplify(l2 - r2)
            if d1 == 0 and d2 == 0:
                return True
            ratio = sympy.simplify(d1 / d2)
            return ratio.is_number and float(ratio) != 0.0
        except Exception:  # noqa: BLE001
            return False
    try:
        import sympy
        diff = sympy.simplify(_sympify(e1) - _sympify(e2))
        if diff == 0:
            return True
        if diff.is_number:
            return abs(float(diff.evalf())) <= precision * 1.01
    except Exception:  # noqa: BLE001
        pass
    return False


def judge(prediction: str, reference: str, precision: float = 1e-8) -> bool:
    """Multi-answer aware equivalence (`judge`, :74-122): answers pair up
    order-independently; every reference answer must be matched."""
    p = extract_boxed(prediction).strip().strip(".").strip("。")
    r = extract_boxed(reference).strip().strip(".").strip("。")
    if p == r:
        return True
    preds = expand_pm(split_top_level(p))
    refs = expand_pm(split_top_level(r))
    if len(preds) != len(refs):
        return False
    remaining = list(preds)
    for ref in refs:
        for cand in remaining:
            if _single_equal(cand, ref, precision):
                remaining.remove(cand)
                break
        else:
            return False
    return True
