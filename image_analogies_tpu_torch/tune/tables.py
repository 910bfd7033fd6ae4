"""Packaged per-device-class geometry (counterpart of the JAX package's
``tune/tables.py``).

A row holds winners measured on that class of card and shipped with the
package, so a fresh install starts from them without a local ``ia tune``.
Precedence, as in the JAX package: override > env > store > packaged >
default (a store entry is a winner measured on the operator's own card).

No TPU row carries over (those are VMEM budgets and Pallas tiles, not
launch plans), and no TPU serve cost rate either (``COST_RATES``).
A row of a class holds only a winner that a committed script measured on
that card: ``ia tune`` run twice in one call, both runs picking the same
winner, the winner beating the default by more than the spread of its own
reps; a comment beside it names the card, its power limit and the run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

TABLES: Dict[str, Dict[str, Dict[str, int]]] = {
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit: empty.  In two
    # calls of `chip_smoke.py` (two `ia tune` runs each; PERF.md's
    # findings) no winner beat the default plans by more than its own
    # reps' spread: packed2k (M = 352, N = 2^20, 223 lanes) took
    # 0.3063-0.3220 ms at every chunks_per_sm x ring_stages candidate,
    # its fastest (a ring of 2 three times, of 4 once) within 0.0023 ms
    # of the default's 0.3076-0.3115; argmin_l2 (M = 88, N = 65,536,
    # F = 68) was fastest at the default, 1 chunk a SM (0.0379-0.0384 ms;
    # 2 and 4: 0.0439-0.0443 and 0.0532-0.0538).
    "h100": {},
}


# Packaged serve cost rates (s per pixel*level*patch^2 work unit,
# ``serve/degrade.py``), keyed "<backend>|<device class>": the degrade
# cost model's prior where the tune store has none.  Empty: no rate
# measured on a card ships yet, so a fresh server starts from the
# optimistic default and learns (``serve.cost_prior.default``).
COST_RATES: Dict[str, float] = {}


def device_class(kind: str) -> Optional[str]:
    """Map a CUDA device name (``torch.cuda.get_device_name``) to a table
    class; None for a device with no packaged table (the CPU, other
    cards, an uninitialized process's "any")."""
    k = (kind or "").lower()
    if "h100" in k:
        return "h100"
    return None


def card_class(device: str) -> str:
    """The table class of the card ``device`` names ("h100"), "cpu" for
    the CPU, "any" where no card answers or it has no table.  Unlike
    ``tune.resolve.device_kind`` this may initialize CUDA: its caller (the
    serve cost model's key) is about to use the card."""
    if not str(device).startswith("cuda"):
        return "cpu"
    try:
        import torch

        if torch.cuda.is_available():
            return device_class(torch.cuda.get_device_name(device)) or "any"
    except Exception:  # noqa: BLE001 - no card: the wildcard class
        pass
    return "any"


def lookup(kind: str, strategy: str, dtype: str) -> Dict[str, Any]:
    """Merged packaged knobs for one resolution key ({} = no table): the
    class's ``"*"`` row, refined by its ``"{strategy}|{dtype}"`` row."""
    cls = device_class(kind)
    if cls is None:
        return {}
    table = TABLES.get(cls, {})
    merged = dict(table.get("*", {}))
    merged.update(table.get(f"{strategy}|{dtype}", {}))
    return merged
