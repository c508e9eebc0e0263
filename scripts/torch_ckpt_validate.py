"""Which checkpoints under a ``weights`` directory are restorable: a standard-library check.

    from torch_ckpt_validate import valid_checkpoints   # with scripts/ on sys.path

``valid_checkpoints`` re-hashes every file a committed checkpoint's manifest
(``manifest.dtp.json``) lists and checks its size and SHA-256, sharing no code with the
port's checkpoint manager, so a soak's "is there something restorable on disk?" cannot
share a bug with the code under test. The port's soaks, ``torch_chaos_soak.py`` and
``torch_fleet_controller.py``, import this one copy (the JAX package's soaks share
``scripts/ckpt_validate.py`` the same way).
"""

from __future__ import annotations

import hashlib
import json
import os

__all__ = ["MANIFEST", "valid_checkpoints"]

MANIFEST = "manifest.dtp.json"


def valid_checkpoints(weights: str) -> "list[str]":
    """Committed checkpoints whose every manifest entry exists with its size and SHA-256
    (a manifest that lists no file is not valid); names sorted, hidden and ``.old``
    entries skipped."""
    good = []
    if not os.path.isdir(weights):
        return good
    for name in sorted(os.listdir(weights)):
        path = os.path.join(weights, name)
        if name.startswith(".") or name.endswith(".old") or not os.path.isdir(path):
            continue
        try:
            with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
                files = json.load(f)["files"]
            ok = bool(files)
            for rel, want in files.items():
                fp = os.path.join(path, rel)
                if not os.path.isfile(fp) or os.path.getsize(fp) != want["size"]:
                    ok = False
                    break
                digest = hashlib.sha256()
                with open(fp, "rb") as fh:
                    for chunk in iter(lambda: fh.read(1 << 22), b""):
                        digest.update(chunk)
                if digest.hexdigest() != want["sha256"]:
                    ok = False
                    break
        except (OSError, ValueError, KeyError, TypeError):
            ok = False
        if ok:
            good.append(name)
    return good
