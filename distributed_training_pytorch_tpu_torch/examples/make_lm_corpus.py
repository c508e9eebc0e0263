"""Materialize a real byte-level LM corpus from the text installed with the interpreter.

The port's own copy of the repository's ``examples/make_lm_corpus.py`` (the port imports
nothing of the JAX package): the same roots in the same order (the standard library's
``.py`` sources, then numpy's ``.py``/``.rst``/``.txt`` and jax's ``.py`` files from each
site directory that has them), the same sorted walk that skips ``__pycache__`` and
``test*`` directories and files that are not UTF-8, and the same minimum size. Where jax
is not installed (the H100 machine), its root is absent and the corpus is other bytes than
on a host that has it; so the entry prints the byte count and the SHA-256 of what it wrote.
Run:

    python -m distributed_training_pytorch_tpu_torch.examples.make_lm_corpus [out_path] [max_mb]

(defaults: ``./runs/lm_corpus.txt``, 24 MB). The output feeds ``LM_CORPUS=<out_path>`` of
``examples/train_lm.py`` and the corpus argument of ``examples/eval_lm.py``.
"""

from __future__ import annotations

import hashlib
import os
import sys

__all__ = ["collect", "main"]


def _roots() -> "list[tuple[str, tuple[str, ...]]]":
    """Text roots in order of preference: the standard library's sources (prose-rich
    docstrings), then installed packages' docs and sources. Found from the running
    interpreter (sysconfig / site), not from fixed paths; walked in sorted order."""
    import site
    import sysconfig

    roots: "list[tuple[str, tuple[str, ...]]]" = []
    stdlib = sysconfig.get_paths().get("stdlib")
    if stdlib:
        roots.append((stdlib, (".py",)))
    site_dirs: "list[str]" = []
    try:
        site_dirs = site.getsitepackages()
    except AttributeError:  # some embedded interpreters
        pass
    for d in site_dirs:
        for pkg, exts in (("numpy", (".py", ".rst", ".txt")), ("jax", (".py",))):
            p = os.path.join(d, pkg)
            if os.path.isdir(p):
                roots.append((p, exts))
    return roots


def collect(max_bytes: int) -> bytes:
    """The first ``max_bytes`` of the roots' text files, each followed by a blank line."""
    chunks: "list[bytes]" = []
    total = 0
    for root, exts in _roots():
        if total >= max_bytes or not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            # prune skipped subtrees in place so os.walk never descends
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__" and not d.startswith("test"))
            for name in sorted(filenames):
                if not name.endswith(tuple(exts)):
                    continue
                path = os.path.join(dirpath, name)
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                try:  # text files only
                    data.decode("utf-8")
                except UnicodeDecodeError:
                    continue
                chunks.append(data)
                chunks.append(b"\n\n")
                total += len(data) + 2
                if total >= max_bytes:
                    break
            if total >= max_bytes:
                break
    return b"".join(chunks)[:max_bytes]


def main(argv: "list[str] | None" = None) -> dict:
    """Write the corpus; returns ``{"path", "bytes", "sha256"}``, which it also prints."""
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "./runs/lm_corpus.txt"
    max_mb = float(argv[1]) if len(argv) > 1 else 24.0
    data = collect(int(max_mb * 1e6))
    # A near-empty corpus would "succeed" here and fail obscurely in train_lm (0 windows).
    minimum = min(int(max_mb * 1e6) // 4, 1_000_000)
    if len(data) < minimum:
        raise SystemExit(
            f"collected only {len(data):,} bytes (< {minimum:,}) — no usable text roots found on this host "
            "(checked stdlib + site-packages)"
        )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        f.write(data)
    digest = hashlib.sha256(data).hexdigest()
    print(f"wrote {len(data):,} bytes of real in-env text to {out} (sha256 {digest})")
    return {"path": out, "bytes": len(data), "sha256": digest}


if __name__ == "__main__":
    main()
