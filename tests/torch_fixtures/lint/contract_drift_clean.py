"""lint fixture: an honored shape/dtype contract (never imported by
product code — loaded by analysis.contracts.check_fixture_module, which
calls it on meta tensors)."""

import torch


def scale_rows(x, w):
    return x * w[:, None]


def row_stats(x):
    return torch.stack([x.amax(dim=1), x.amin(dim=1)])


def pick(x):
    return x.argmax(dim=1).to(torch.int32), (x > 0).any(dim=1)


CONTRACTS = [
    {
        "fn": "scale_rows",
        "args": [("float32", ("n", "r")), ("float32", ("n",))],
        "out": ("float32", ("n", "r")),
        "grid": [{"n": 8, "r": 4}, {"n": 16, "r": 4}],
    },
    {
        "fn": "row_stats",
        "args": [("float32", ("n", "r"))],
        "out": ("float32", (2, "n")),
        "grid": [{"n": 8, "r": 4}],
    },
    {
        "fn": "pick",
        "args": [("float32", ("p", "n"))],
        "out": [("int32", ("p",)), ("bool", ("p",))],
        "grid": [{"p": 8, "n": 16}],
    },
]
