"""Dot FLOPs of the reference's lowered StableHLO, for the port's dry-run
tests: every ``stablehlo.dot_general`` counted at ``2 x output elements x
contracted size``, each private function as often as it is called."""
from __future__ import annotations

import math
import re

_FUNC = re.compile(r"^\s*func\.func \w+ @([\w.$-]+)\(")
_CALL = re.compile(r"call @([\w.$-]+)\(")
_CONTRACT = re.compile(r"contracting_dims = \[([\d, ]*)\] x \[([\d, ]*)\]")
_TYPES = re.compile(r":\s*\((tensor<[^>]*>),\s*(tensor<[^>]*>)\)\s*->\s*(tensor<[^>]*>)")


def _dims(t: str):
    body = t[len("tensor<"):-1]
    return [int(d) for d in body.split("x")[:-1]]


def dot_flops(line: str) -> int:
    lhs, _, out = _TYPES.search(line).groups()
    contract = [int(i) for i in _CONTRACT.search(line).group(1).split(",") if i.strip()]
    lhs_dims = _dims(lhs)
    return 2 * math.prod(_dims(out)) * math.prod(lhs_dims[i] for i in contract)


def hlo_dot_flops(text: str) -> int:
    """The dot FLOPs of ``main`` with its calls expanded.  Raises on a dot
    or a call inside a ``stablehlo.while`` (a loop's body would count
    once); a loop of elementwise work (the SSD's state pass) passes."""
    funcs, cur = {}, None
    depth, loop_depth = 0, None  # brace depth; the depth a while loop opened at
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            funcs[cur] = [0, []]
        elif cur is not None:
            if "stablehlo.while" in line and loop_depth is None:
                loop_depth = depth
            inside = loop_depth is not None
            if "stablehlo.dot_general" in line:
                if inside:
                    raise ValueError("a dot inside a while loop: unroll the scan")
                funcs[cur][0] += dot_flops(line)
            calls = _CALL.findall(line)
            if calls and inside:
                raise ValueError("a call inside a while loop: unroll the scan")
            funcs[cur][1].extend(calls)
        depth += line.count("{") - line.count("}")
        if loop_depth is not None and depth <= loop_depth:
            loop_depth = None
    memo = {}

    def total(name):
        if name not in memo:
            own, calls = funcs[name]
            memo[name] = own + sum(total(c) for c in calls)
        return memo[name]

    return total("main")
