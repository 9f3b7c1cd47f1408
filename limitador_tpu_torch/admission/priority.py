"""Request priority classes for admission-plane shedding.

Port counterpart of ``limitador_tpu/admission/priority.py``. Four
classes, ordered: ``low < normal < high < critical``. A request's class
resolves from (highest precedence first):

1. a descriptor entry (key ``priority`` by default, ``--priority-key``)
   whose value is a class name or its 0-3 level;
2. the namespace mapping (``--priority NS=CLASS``, repeatable);
3. limits-file annotations: a limit entry may carry ``priority: high``,
   and the namespace inherits the HIGHEST annotated class of its limits;
4. the default class (``normal``).

The resolver never raises on malformed input: an unknown class name
falls through to the next source, so that a hostile descriptor cannot
turn shedding into a parse-error crash loop.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

__all__ = [
    "PRIORITIES",
    "DEFAULT_PRIORITY",
    "priority_level",
    "priority_name",
    "PriorityResolver",
]

PRIORITIES = ("low", "normal", "high", "critical")
DEFAULT_PRIORITY = 1  # "normal"

_LEVELS: Dict[str, int] = {name: i for i, name in enumerate(PRIORITIES)}
for _i in range(len(PRIORITIES)):
    _LEVELS[str(_i)] = _i


def priority_level(value, default: Optional[int] = None) -> Optional[int]:
    """Class name or numeric level -> 0-3 level; ``default`` when the
    value names no class (None, empty, unknown)."""
    if isinstance(value, int) and 0 <= value < len(PRIORITIES):
        return value
    if isinstance(value, str):
        level = _LEVELS.get(value.strip().lower())
        if level is not None:
            return level
    return default


def priority_name(level: int) -> str:
    return PRIORITIES[max(0, min(int(level), len(PRIORITIES) - 1))]


class PriorityResolver:
    """namespace/descriptor -> priority level, per the precedence above.

    ``refresh(limits)`` re-derives the annotation layer on every limits
    reload; the command-line layer is fixed at startup. Reads are
    lock-free (a plain dict swap): resolution rides the per-request hot
    path.
    """

    def __init__(
        self,
        descriptor_key: str = "priority",
        namespace_map: Optional[Dict[str, int]] = None,
        default: int = DEFAULT_PRIORITY,
    ):
        self.descriptor_key = descriptor_key
        self.default = default
        self._cli: Dict[str, int] = dict(namespace_map or {})
        self._annotated: Dict[str, int] = {}

    @classmethod
    def parse_namespace_map(cls, pairs: Iterable[str]) -> Dict[str, int]:
        """Parse repeatable ``NS=CLASS`` option values; raises ValueError
        on a malformed pair (a configuration error fails startup, unlike
        a per-request descriptor value)."""
        out: Dict[str, int] = {}
        for pair in pairs or ():
            ns, sep, cls_name = pair.partition("=")
            level = priority_level(cls_name)
            if not sep or not ns or level is None:
                raise ValueError(
                    f"bad --priority mapping {pair!r}; expected "
                    f"NAMESPACE=({'|'.join(PRIORITIES)})"
                )
            out[ns] = level
        return out

    def refresh(self, limits) -> None:
        """Re-derive namespace priorities from limits-file annotations
        (``Limit.priority``); the namespace takes its limits' maximum."""
        annotated: Dict[str, int] = {}
        for limit in limits or ():
            level = priority_level(getattr(limit, "priority", None))
            if level is None:
                continue
            ns = str(limit.namespace)
            prev = annotated.get(ns)
            if prev is None or level > prev:
                annotated[ns] = level
        self._annotated = annotated

    def resolve(self, namespace, values: Optional[dict] = None) -> int:
        """Priority level for one request; ``values`` is the first
        descriptor's entry map (what the serving plane binds as
        ``descriptors[0]``)."""
        if values:
            level = priority_level(values.get(self.descriptor_key))
            if level is not None:
                return level
        ns = str(namespace)
        level = self._cli.get(ns)
        if level is not None:
            return level
        return self._annotated.get(ns, self.default)
