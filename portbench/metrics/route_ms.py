"""Median wall of the routing policy's ``route`` (featurize, Q-network,
masked argmax)."""
import statistics


def read(r):
    walls = [b - a for a, b in r.routes]
    return statistics.median(walls) * 1e3 if walls else None
