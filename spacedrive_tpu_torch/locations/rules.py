"""Indexer rules: glob accept/reject + child-directory presence checks.

Port of ``spacedrive_tpu/locations/rules.py``; the rule blobs pack
through the port's msgpack codec, byte-equal to the JAX package's.

Behavioral equivalent of the reference's rule system
(upstream core/src/location/indexer/rules/mod.rs:152-614): four rule
kinds, msgpack-serialized parameters persisted per rule row, and the same
seeded system rules (upstream core/src/location/indexer/rules/seed.rs
— Linux subset, since this framework targets Linux/TPU hosts).

Application semantics (walk.rs:476-600, encoded in walker.py):
- RejectFilesByGlob: any match rejects the entry.
- AcceptFilesByGlob: if any accept-glob rule exists, at least one must
  match or the entry is skipped (dirs are still descended into).
- Accept/RejectIfChildrenDirectoriesArePresent: applied to directories by
  listing their children's names.
"""

from __future__ import annotations

import enum
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from .. import _msgpack
from .glob import GlobSet


class RuleKind(enum.IntEnum):
    ACCEPT_FILES_BY_GLOB = 0
    REJECT_FILES_BY_GLOB = 1
    ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 2
    REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 3


@dataclass
class RulePerKind:
    kind: RuleKind
    # Glob patterns for the *_FILES_BY_GLOB kinds, child dir names otherwise.
    params: Tuple[str, ...]
    _glob_set: GlobSet = field(init=False, repr=False)

    def __post_init__(self):
        if self.kind in (RuleKind.ACCEPT_FILES_BY_GLOB,
                         RuleKind.REJECT_FILES_BY_GLOB):
            self._glob_set = GlobSet(self.params)
        else:
            self._glob_set = GlobSet(())

    def apply(self, source: str | os.PathLike) -> Tuple[RuleKind, bool]:
        """Returns (kind, passed). `passed=False` on a reject kind means the
        entry was rejected (rules/mod.rs:431-453 returns the same polarity:
        reject rules yield `!matched`)."""
        src = os.fspath(source)
        if self.kind == RuleKind.ACCEPT_FILES_BY_GLOB:
            return (self.kind, self._glob_set.is_match(src))
        if self.kind == RuleKind.REJECT_FILES_BY_GLOB:
            return (self.kind, not self._glob_set.is_match(src))
        if self.kind == RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT:
            return (self.kind, self._check_children(src, accept=True))
        return (self.kind, self._check_children(src, accept=False))

    def _check_children(self, src: str, accept: bool) -> bool:
        """accept_dir_for_its_children / reject_dir_for_its_children
        (rules/mod.rs:526-614): scan child dir names against params."""
        children: Set[str] = set(self.params)
        try:
            if not os.path.isdir(src):
                return False if accept else True
            with os.scandir(src) as it:
                for entry in it:
                    if entry.is_dir(follow_symlinks=False) and \
                            entry.name in children:
                        return accept
        except OSError:
            return False if accept else True
        return not accept


@dataclass
class IndexerRule:
    name: str
    rules: List[RulePerKind]
    default: bool = False
    pub_id: bytes = b""

    def apply(self, source: str | os.PathLike) -> List[Tuple[RuleKind, bool]]:
        return [r.apply(source) for r in self.rules]

    # -- persistence (msgpack blob in indexer_rule.rules_per_kind) ---------

    def serialize_rules(self) -> bytes:
        return _msgpack.packb(
            [[int(r.kind), list(r.params)] for r in self.rules])

    @classmethod
    def from_row(cls, row) -> "IndexerRule":
        raw = _msgpack.unpackb(row["rules_per_kind"])
        return cls(
            name=row["name"],
            rules=[RulePerKind(RuleKind(k), tuple(params)) for k, params in raw],
            default=bool(row["default_rule"]),
            pub_id=row["pub_id"],
        )


def apply_all(
    rules: Sequence[IndexerRule], source: str | os.PathLike
) -> Dict[RuleKind, List[bool]]:
    """IndexerRule::apply_all (rules/mod.rs:476-494): kind → result list."""
    out: Dict[RuleKind, List[bool]] = {}
    for rule in rules:
        for kind, passed in rule.apply(source):
            out.setdefault(kind, []).append(passed)
    return out


# -- seeded system rules (seed.rs:72-220, Linux/unix subset) ---------------

def no_os_protected() -> IndexerRule:
    return IndexerRule(
        name="No OS protected",
        default=True,
        rules=[RulePerKind(RuleKind.REJECT_FILES_BY_GLOB, (
            "**/.spacedrive",
            # Linux (seed.rs:142-154)
            "**/*~",
            "**/.fuse_hidden*",
            "**/.directory",
            "**/.Trash-*",
            "**/.nfs*",
            # unix (seed.rs:160-170)
            "/{dev,sys,proc}",
            "/{run,var,boot}",
            "**/lost+found",
        ))],
    )


def no_hidden() -> IndexerRule:
    return IndexerRule(
        name="No Hidden",
        rules=[RulePerKind(RuleKind.REJECT_FILES_BY_GLOB, ("**/.*",))],
    )


def no_git() -> IndexerRule:
    return IndexerRule(
        name="No Git",
        rules=[RulePerKind(RuleKind.REJECT_FILES_BY_GLOB, (
            "**/{.git,.gitignore,.gitattributes,.gitkeep,.gitconfig,.gitmodules}",
        ))],
    )


def only_images() -> IndexerRule:
    return IndexerRule(
        name="Only Images",
        rules=[RulePerKind(RuleKind.ACCEPT_FILES_BY_GLOB, (
            "*.{avif,bmp,gif,ico,jpeg,jpg,png,svg,tif,tiff,webp}",
        ))],
    )


SYSTEM_RULES = (no_os_protected, no_hidden, no_git, only_images)


def seed_system_rules(db) -> None:
    """Upsert the system rules with stable pub_ids derived from their seed
    index (seed.rs:38-69: uuid_from_u128(i)). DO NOT REORDER."""
    now = int(time.time())
    with db.write_tx() as conn:  # one tx for the whole seed set
        for i, factory in enumerate(SYSTEM_RULES):
            rule = factory()
            pub_id = i.to_bytes(16, "big")
            db.upsert(
                "indexer_rule",
                {"pub_id": pub_id},
                {
                    "name": rule.name,
                    "default_rule": int(rule.default),
                    "rules_per_kind": rule.serialize_rules(),
                    "date_created": now,
                    "date_modified": now,
                },
                conn=conn,
            )


def load_rules_for_location(db, location_id: int) -> List[IndexerRule]:
    rows = db.run("location.rules_for", (location_id,))
    return [IndexerRule.from_row(r) for r in rows]
