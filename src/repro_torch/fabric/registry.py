"""Persistent fragment registry: cross-window, cross-front-end memory of
which query fragments are hot.

The planner's common-subexpression factoring is per-window: a fragment
shared by two queries *inside* one dispatch window is evaluated once and
(if boolean) materialized into the result cache.  But interactive traffic
repeats across windows and across fleet members — the same
``count(pt > 15) >= 2`` conjunct shows up all day, often only once per
window, so the ≥2-references materialization rule never fires and the
fragment is recomputed forever.  The registry closes that gap
(ROADMAP: "Cross-window fragment reuse"):

- every planned window is :meth:`observed <FragmentRegistry.observe_plan>`
  — each boolean scalar-context fragment's reference count and
  windows-seen count accumulate fleet-wide (one registry serves every
  front-end);
- each NEW window's planning :meth:`seeds <FragmentRegistry.seed_interner>`
  its :class:`~repro_torch.core.query.Interner` with the hot fragments, so a
  hot fragment occurring in the window shares node identity with the
  registry's copy and can be recognized by ``id()``;
- hot fragments present in the window are *pre-warmed*: marked for
  materialization even when referenced by a single query, so the scan's
  by-product lands in the (shared) fragment cache and the next
  submission equal to that fragment — on any front-end — is a zero-I/O
  hit.

The registry is plain data (canonical fragment strings + counters) and
serializes to JSON (:meth:`save`/:meth:`load`), surviving front-end
restarts the way the paper's metadata catalogue survives JSE restarts.

Pre-warming never changes results: a materialized fragment is an extra
plan target evaluated from the same shared memo, and per-query roots are
untouched (``tests/test_fabric.py`` pins registry-seeded windows
bit-identical to unseeded planning).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Union

from repro_torch.core import query as query_lib


@dataclasses.dataclass
class FragmentRecord:
    """Accumulated history of one canonical fragment: total references
    across all observed windows, number of distinct windows it appeared
    in, and the last window index that referenced it."""
    key: str
    refs: int = 0
    windows: int = 0
    last_window: int = -1


class FragmentRegistry:
    """Fleet-wide fragment heat tracker + interner seeder (see module
    docstring).

    Parameters
    ----------
    hot_min_windows:
        A fragment becomes *hot* once it has appeared in at least this
        many distinct windows (2 by default: one window of history is
        enough to start pre-warming, zero history never is).
    max_hot:
        Upper bound on fragments returned by :meth:`hot` / seeded into an
        interner — keeps per-window planning overhead bounded no matter
        how long the registry lives.
    """

    def __init__(self, *, hot_min_windows: int = 2, max_hot: int = 16):
        self.hot_min_windows = hot_min_windows
        self.max_hot = max_hot
        self.records: Dict[str, FragmentRecord] = {}
        self.windows_observed = 0

    # ------------------------------------------------------------------ #
    def observe_plan(self, plan: "query_lib.FragmentPlan") -> None:
        """Fold one planned window into the registry: every boolean
        scalar-context fragment of the plan (root or not) gets its
        reference and window counters advanced."""
        from repro_torch.service import planner as planner_lib
        window = self.windows_observed
        self.windows_observed += 1
        for node, nrefs in planner_lib.boolean_fragment_refs(plan):
            key = query_lib.node_key(node)
            rec = self.records.get(key)
            if rec is None:
                rec = self.records[key] = FragmentRecord(key)
            rec.refs += nrefs
            if rec.last_window != window:
                rec.windows += 1
                rec.last_window = window

    def hot(self, limit: Optional[int] = None) -> List[str]:
        """Canonical keys of the hottest fragments (appeared in >=
        ``hot_min_windows`` windows), most-referenced first, bounded by
        ``limit`` (default ``max_hot``)."""
        limit = self.max_hot if limit is None else limit
        cands = [r for r in self.records.values()
                 if r.windows >= self.hot_min_windows]
        cands.sort(key=lambda r: (-r.refs, -r.windows, r.key))
        return [r.key for r in cands[:limit]]

    def seed_interner(self, interner: "query_lib.Interner"
                      ) -> Dict[str, "query_lib.Node"]:
        """Intern every hot fragment into ``interner`` (BEFORE the window's
        queries are interned) and return ``{canonical key: shared node}``.
        Any query in the window containing a hot fragment then shares the
        returned node object, so the planner can recognize hot fragments
        by identity and mark them for materialization."""
        out = {}
        for key in self.hot():
            try:
                out[key] = interner.intern(query_lib.parse(key))
            except query_lib.QueryError:  # never let a corrupt record plan
                continue
        return out

    # ------------------------------------------------------------------ #
    def to_json(self) -> str:
        """Serialize the registry (records + window counter) to JSON."""
        return json.dumps({
            "windows_observed": self.windows_observed,
            "hot_min_windows": self.hot_min_windows,
            "max_hot": self.max_hot,
            "records": {k: dataclasses.asdict(v)
                        for k, v in self.records.items()},
        })

    @classmethod
    def from_json(cls, text: str) -> "FragmentRegistry":
        """Rebuild a registry from :meth:`to_json` output."""
        data = json.loads(text)
        reg = cls(hot_min_windows=data.get("hot_min_windows", 2),
                  max_hot=data.get("max_hot", 16))
        reg.windows_observed = data.get("windows_observed", 0)
        for k, v in data.get("records", {}).items():
            reg.records[k] = FragmentRecord(**v)
        return reg

    def save(self, path: Union[str, pathlib.Path]) -> None:
        """Persist to ``path`` (restart survival, like the catalogue)."""
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "FragmentRegistry":
        """Load a registry persisted by :meth:`save`."""
        return cls.from_json(pathlib.Path(path).read_text())

    def __len__(self) -> int:
        return len(self.records)
