"""Computation models as strategy objects (paper Sec. IV-B2), as in the JAX
package's ``plug/computation.py``.

A model decides *when* the daemons run Gen relative to Merge/Apply through
three hooks the drive loop calls: ``prologue(gather)`` before the loop,
``aggregates(gather, pending, record)`` for the aggregates this iteration's
Merge consumes, and ``epilogue(gather, record)`` after Apply.  BSP and GAS
produce identical trajectories on the same template.  The asynchronous
priority model comes with the async slice (ROADMAP Queue A item 8).
"""
from __future__ import annotations

from repro_torch.plug.protocols import not_ported


class BSP:
    """Bulk-synchronous: Gen → Merge → Apply inside one superstep."""

    name = "bsp"
    order = ("gen", "merge", "apply")

    def prologue(self, gather):
        return None

    def aggregates(self, gather, pending, record):
        return gather(record)

    def epilogue(self, gather, record):
        return None


class GAS:
    """Gather-Apply-Scatter ordering: Merge → Apply → Gen; the scatter at
    the end of iteration *t* produces the messages iteration *t+1*
    consumes (PowerGraph's ordering)."""

    name = "gas"
    order = ("merge", "apply", "gen")

    def prologue(self, gather):
        return gather({})

    def aggregates(self, gather, pending, record):
        return pending

    def epilogue(self, gather, record):
        return gather(record)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_MODELS: dict = {}


def register_model(name: str, factory) -> None:
    _MODELS[name] = factory


def get_model(name: str, **kwargs):
    try:
        factory = _MODELS[name]
    except KeyError:
        raise KeyError(f"unknown computation model {name!r}; registered: "
                       f"{sorted(_MODELS)}") from None
    return factory(**kwargs)


def model_names() -> tuple:
    return tuple(sorted(_MODELS))


register_model("bsp", BSP)
register_model("gas", GAS)
register_model("async", not_ported('model="async"', 8))
