"""Test sizes of the traffic kinds that small.py's and
test_portbench_card.py's tables do not name, registered before the tests
read them, so that a kind added as new files runs through every test that
takes each cell at test size.

The terrain kind (portbench/kinds/terrain.py) takes the sweep kind's
sizes and cut, and its checked cycle is the second; its lanes spawn at the
features' edge (y 0.85-0.95 m, the front feet on the feature), since a
20-tick cycle walks a few centimetres and the ground has to matter in the
checked cycle."""

from __future__ import annotations

from . import small

TERRAIN = dict(small.SIZES["sweep"], check_cycle=1, spawn_y=[0.85, 0.95])
small.SIZES.setdefault("terrain", TERRAIN)
CUT = ("terrain",)      # kinds whose replan cycles small.cell cuts too

_cell = small.cell


def _cell_cut(name: str):
    c = _cell(name)
    if c.traffic["kind"] in CUT:
        g = c.config["engine"]["gait"]
        g["trot_cycle"] = g["crawl_cycle"] = g["fixed_cycle"] = 0.05
    return c


small.cell = _cell_cut


def pytest_collection_modifyitems(items):
    """test_portbench_card.py's card sizes for the kinds it lacks: the
    sweep kind's."""
    for item in items:
        sizes = getattr(getattr(item, "module", None), "CARD_SIZES", None)
        if sizes is not None:
            sizes.setdefault("terrain", dict(sizes["sweep"]))
