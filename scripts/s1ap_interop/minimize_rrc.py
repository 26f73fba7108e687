"""Delta-debug a failing RRC differential-fuzz case to a minimal value.

Usage: python minimize_rrc.py <channel> <hex> [harness=/tmp/unpack_rrc]

Greedily (a) removes optional SEQUENCE fields, (b) shrinks SEQUENCE OF
lists, (c) nulls CHOICE branches to their simplest sibling — keeping each
simplification only if the reference harness STILL disagrees.  The
survivor names the divergent schema node.
"""

import subprocess
import sys

import os
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from srslte_emane_tpu.stack.asn1 import rrc36331 as rrc
from srslte_emane_tpu.stack.asn1.runtime import uper_decode, uper_encode

S = {"ul_ccch": rrc.UL_CCCH_MSG, "dl_ccch": rrc.DL_CCCH_MSG,
     "ul_dcch": rrc.UL_DCCH_MSG, "dl_dcch": rrc.DL_DCCH_MSG,
     "pcch": rrc.PCCH_MSG, "bcch_dl_sch": rrc.BCCH_DL_SCH_MSG}


def run_harness(harness, chan, data: bytes) -> str:
    """'ok' | 'mismatch <hex>' | 'fail'"""
    line = f"{chan} x {data.hex()}\n"
    out = subprocess.run([harness], input=line, capture_output=True,
                         text=True, timeout=30).stdout.strip()
    if out.startswith("REPACK"):
        got = out.split()[2]
        return "ok" if got == data.hex() else f"mismatch {got}"
    return "fail"


def fails(harness, chan, schema, v) -> bool:
    try:
        b = uper_encode(schema, v)
    except Exception:
        return False  # invalid simplification: not a keeper
    if uper_encode(schema, uper_decode(schema, b)) != b:
        return False  # broke our own round trip: not a keeper
    return run_harness(harness, chan, b) != "ok"


def simplify(v, path, replace):
    """Copy of v with the node at `path` replaced via replace(node)."""
    if not path:
        return replace(v)
    head, rest = path[0], path[1:]
    if isinstance(v, dict):
        out = dict(v)
        out[head] = simplify(v[head], rest, replace)
        return out
    if isinstance(v, tuple):
        return (v[0], simplify(v[1], rest, replace))
    if isinstance(v, list):
        out = list(v)
        out[head] = simplify(v[head], rest, replace)
        return out
    raise TypeError(type(v))


def walk(v, path=()):
    yield path, v
    if isinstance(v, dict):
        for k, x in v.items():
            yield from walk(x, path + (k,))
    elif isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
        yield from walk(v[1], path + (None,))
    elif isinstance(v, list):
        for i, x in enumerate(v):
            yield from walk(x, path + (i,))


def _simple(leaf):
    """Candidate 'boring' replacements for a leaf value."""
    if isinstance(leaf, bool):
        return [False]
    if isinstance(leaf, int):
        return [0, 1]
    if isinstance(leaf, bytes):
        return [b"\x00" * len(leaf)] if leaf else []
    if isinstance(leaf, str):
        if set(leaf) <= {"0", "1"}:
            return ["0" * len(leaf)]
    return []


def minimize(harness, chan, schema, v, values: bool = True):
    changed = True
    while changed:
        changed = False
        # (a) remove optional dict keys, deepest first
        nodes = sorted(walk(v), key=lambda p: -len(p[0]))
        for path, node in nodes:
            if isinstance(node, dict):
                for k in list(node.keys()):
                    cand = simplify(v, path, lambda d: {
                        kk: vv for kk, vv in d.items() if kk != k})
                    if fails(harness, chan, schema, cand):
                        v = cand
                        changed = True
            elif isinstance(node, list) and len(node) > 1:
                for keep in range(len(node)):
                    cand = simplify(v, path, lambda l, i=keep: [l[i]])
                    if fails(harness, chan, schema, cand):
                        v = cand
                        changed = True
                        break
    if not values:
        return v
    # (b) simplify leaf values: survivors mark the divergent fields
    for path, node in sorted(walk(v), key=lambda p: -len(p[0])):
        for repl in _simple(node):
            if repl == node:
                continue
            cand = simplify(v, path, lambda _x, r=repl: r)
            if fails(harness, chan, schema, cand):
                v = cand
                break
    return v


def main():
    chan = sys.argv[1]
    data = bytes.fromhex(sys.argv[2])
    harness = sys.argv[3] if len(sys.argv) > 3 else "/tmp/unpack_rrc"
    schema = S[chan]
    v = uper_decode(schema, data)
    verdict = run_harness(harness, chan, data)
    print("initial verdict:", verdict)
    assert verdict != "ok"
    v = minimize(harness, chan, schema, v)
    import pprint
    print("MINIMAL failing value:")
    pprint.pprint(v, width=110)
    b = uper_encode(schema, v)
    print("encoded:", b.hex())
    print("harness:", run_harness(harness, chan, b))


if __name__ == "__main__":
    main()
