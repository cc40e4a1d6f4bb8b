"""Moves scored a step by one island, by a static rule that needs no read
from the device. The rule is the workload's "moves", a module of this
package: `per_island_step(config, agent_args)`."""

import importlib


def per_island_step(config, workload):
    rule = importlib.import_module(
        f"gjbench.metrics._moves.{workload['moves']}")
    return rule.per_island_step(config, workload["agent_args"])
