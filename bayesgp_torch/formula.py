"""Formula front-end: `"y ~ x1 + x2 + f(t, model='IWP', order=3, k=30)"`.

Mirrors the reference's formula DSL (`f()` marker R/01_utility.R:1-15,
`parse_formula` R/01_utility.R:17-31) with a Python string grammar: the RHS
is split on top-level `+`; terms spelled `f(...)` become random-effect
specs, everything else is a fixed effect (column name). `f(...)` arguments
are parsed with Python's `ast` so all reference options work verbatim:
`model`, `order`, `k`, `knots`, `sd.prior`/`sd_prior`, `boundary.prior`,
`initial_location`, `a`/`freq`/`period`, `m`, `region`, `accuracy`,
`boundary`. Identifiers are resolved from the optional `env` dict.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any


@dataclass
class RandomEffectCall:
    """An unevaluated f(...) call: smoothing variable + raw options."""
    smoothing_var: str
    options: dict = field(default_factory=dict)


@dataclass
class ParsedFormula:
    response: str
    fixed_effects: list
    rand_effects: list


def f(smoothing_var, model=None, **options) -> RandomEffectCall:
    """The `f()` formula marker as a real Python callable.

    The reference exports `f` (R/01_utility.R:1-15), which captures its
    own call unevaluated for `parse_formula` to pick apart; the Python
    equivalent simply returns the unevaluated `RandomEffectCall` that
    `model_fit(terms=[...])` consumes directly:

        model_fit(response="y", fixed=["z"], family="Poisson", data=data,
                  terms=[f("x", model="IWP", order=3, k=30)])

    `smoothing_var` is the data column NAME. Dotted R option spellings
    (`sd.prior`, `boundary.prior`, `initial.location`) are accepted via
    `**{"sd.prior": ...}` and normalized to underscores, matching
    `parse_f_call`'s string path.
    """
    opts = {k.replace(".", "_"): v for k, v in options.items()}
    if model is not None:
        opts = {"model": model, **opts}
    return RandomEffectCall(smoothing_var=str(smoothing_var), options=opts)


def _split_top_level(s: str, sep: str = "+"):
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
    return [p.strip() for p in parts if p.strip()]


def _eval_node(node: ast.AST, env: dict) -> Any:
    """Evaluate an f() argument: literals, names from env, simple exprs."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if env and node.id in env:
            return env[node.id]
        return node.id  # bare identifier -> its name (e.g. model=IWP)
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_eval_node(e, env) for e in node.elts]
    if isinstance(node, ast.Dict):
        return {_eval_node(k, env): _eval_node(v, env)
                for k, v in zip(node.keys, node.values)}
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval_node(node.operand, env)
    if isinstance(node, ast.BinOp):
        left, right = _eval_node(node.left, env), _eval_node(node.right, env)
        ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
               ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
               ast.Pow: lambda a, b: a ** b}
        return ops[type(node.op)](left, right)
    if isinstance(node, ast.Call):
        # allow dict(...) style and list(...)-style option spellings
        fn = node.func.id if isinstance(node.func, ast.Name) else None
        if fn in ("dict", "list"):
            return {kw.arg: _eval_node(kw.value, env) for kw in node.keywords}
        raise ValueError(f"unsupported call in f() options: {ast.dump(node)}")
    raise ValueError(f"unsupported expression in f() options: {ast.dump(node)}")


def parse_f_call(term: str, env: dict | None = None) -> RandomEffectCall:
    """Parse one `f(...)` term string into a RandomEffectCall."""
    env = env or {}
    # R-style option names use dots; map to underscores for ast parsing
    src = term.replace("sd.prior", "sd_prior").replace(
        "boundary.prior", "boundary_prior").replace(
        "initial.location", "initial_location")
    tree = ast.parse(src, mode="eval").body
    if not isinstance(tree, ast.Call):
        raise ValueError(f"not a call: {term}")
    args = list(tree.args)
    kwargs = {kw.arg: kw.value for kw in tree.keywords}

    smoothing_var = None
    for key in ("smoothing_var", "x"):
        if key in kwargs:
            node = kwargs.pop(key)
            smoothing_var = node.id if isinstance(node, ast.Name) else _eval_node(node, env)
            break
    pos_model = None
    if smoothing_var is None:
        if not args:
            raise ValueError(
                "f() needs a smoothing variable as first argument or "
                "smoothing_var=/x= keyword")
        first = args.pop(0)
        smoothing_var = first.id if isinstance(first, ast.Name) else _eval_node(first, env)
    if args:  # second positional arg is the model class (reference f() signature)
        pos_model = _eval_node(args.pop(0), env)

    options = {k: _eval_node(v, env) for k, v in kwargs.items()}
    if pos_model is not None and "model" not in options:
        options["model"] = pos_model
    return RandomEffectCall(smoothing_var=str(smoothing_var), options=options)


def parse_formula(formula: str, env: dict | None = None) -> ParsedFormula:
    """Split a formula string into response / fixed effects / f() calls.

    Reference semantics: parse_formula at R/01_utility.R:17-31.
    """
    if "~" not in formula:
        raise ValueError("formula must contain '~'")
    lhs, rhs = formula.split("~", 1)
    response = lhs.strip()
    if not response:
        raise ValueError("formula must have a response variable")
    fixed, rand = [], []
    for term in _split_top_level(rhs):
        stripped = term.replace(" ", "")
        if stripped.startswith("f("):
            rand.append(parse_f_call(term, env))
        elif stripped in ("1", "0"):
            continue  # intercept is implicit (always included except coxph/cc)
        else:
            fixed.append(term)
    return ParsedFormula(response=response, fixed_effects=fixed, rand_effects=rand)
