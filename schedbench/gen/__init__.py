"""Inputs drawn from the seed: the cluster and its pods (cluster.py) and
the arrivals of the traffic mixes (traffic.py)."""
