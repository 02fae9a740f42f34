"""lint fixture: a shape/dtype contract DRIFT (never imported by product
code — loaded by analysis.contracts.check_fixture_module, which calls it
on meta tensors).

The declared contract says `scale_rows` preserves [n, r] float32; the
implementation transposes — the class of fused/unfused drift the
engine-contract layer exists to catch before a run on the card does."""

import torch


def scale_rows(x, w):
    # drift: returns [r, n], the declaration says [n, r]
    return (x * w[:, None]).T


def cast_rows(x):
    # drift: changes dtype vs the declared float32
    return x.to(torch.int32)


CONTRACTS = [
    {
        "fn": "scale_rows",
        "args": [("float32", ("n", "r")), ("float32", ("n",))],
        "out": ("float32", ("n", "r")),
        "grid": [{"n": 8, "r": 4}, {"n": 16, "r": 4}],
    },
    {
        "fn": "cast_rows",
        "args": [("float32", ("n", "r"))],
        "out": ("float32", ("n", "r")),
        "grid": [{"n": 8, "r": 4}],
    },
]
