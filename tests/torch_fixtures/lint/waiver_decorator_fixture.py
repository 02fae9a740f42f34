"""Lint fixture: a waiver above a decorator covers the whole def (never
imported)."""

import functools

import torch


# graftlint: disable=dtype-shape -- fixture: decorated-def waiver covers the body finding
@functools.lru_cache(maxsize=None)
def table_waived(n):
    return torch.zeros(n, dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def table_unwaived(n):
    return torch.zeros(n, dtype=torch.float64)
