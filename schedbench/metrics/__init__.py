"""One reader per metric, found by the metric's name: `<name>.py` holds
`read(run) -> float | None`. A reader that finds nothing to read returns
None, and the harness leaves the metric out of the result. Shared
arithmetic lives in `_shared.py`."""
