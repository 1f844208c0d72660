"""The benchmark's spans around the port's entries: a ``record_function``
range, named by layer, around each call of the entries that the cell's
per-layer metrics name (``SPANS`` in ``benchmark/metrics/<metric>.py``)
while a traced window is open, and a plain call otherwise. The port has no
spans of its own yet; an entry that no longer exists is skipped, and a
metric that reads its span then finds nothing and is left out.
"""

from __future__ import annotations

import functools
import importlib
from typing import Dict, Iterable, Set, Tuple

ACTIVE = False
NAMES: Set[str] = set()  # the spans installed


def _wrap(name: str, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def spanned(*a, **kw):
        if not ACTIVE:
            return fn(*a, **kw)
        with record_function(name):
            return fn(*a, **kw)

    spanned.__wrapped_by_bench__ = True
    return spanned


def install(entries: Dict[str, Iterable[Tuple[str, str]]]) -> Dict[str, int]:
    """Wrap every entry that exists, ``entries`` mapping a span's name to the
    (module, attribute) of the port's functions it wraps; returns the
    entries wrapped per span."""
    installed = {}
    for name, pairs in entries.items():
        n = 0
        for mod, attr in pairs:
            try:
                m = importlib.import_module(mod)
            except ImportError:
                continue
            fn = getattr(m, attr, None)
            if fn is None:
                continue
            if not getattr(fn, "__wrapped_by_bench__", False):
                setattr(m, attr, _wrap(name, fn))
            n += 1
        installed[name] = n
        NAMES.add(name)
    return installed
