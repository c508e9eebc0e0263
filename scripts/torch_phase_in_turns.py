#!/usr/bin/env python3
"""Run one ``chip_smoke.py`` phase of two unpacked checkouts in turns on the card.

    python3 scripts/torch_phase_in_turns.py --phase vgg build/parent_tree build/change_tree

Each checkout holds its own ``chip_smoke.py`` and port package (unpack them with ``git
archive <commit> | tar -x -C <dir>`` into a directory that ``.gitignore`` lists). The
phase runs four times, first tree, second, second, first, each in its own process, and
prints the figures the phase returns (its median step, the host's time to issue a step,
the busy share of the resumed train epoch, where the phase reports them) as one JSON line
a run, so that the two versions are compared on one card in one call. Phases: ``vgg``,
``folder`` and ``train`` (the LM entry, GPT-2-small at B=64, T=1024). ``--sync-saves``
makes a port ``Trainer`` that has background saves save synchronously, as one without them
does, so that no commit overlaps the steps timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import json, os, sys, tempfile
tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, tree)
import chip_smoke
if sys.argv[3] == "sync":
    import inspect
    from distributed_training_pytorch_tpu_torch.trainer import trainer as trainer_module
    init = trainer_module.Trainer.__init__
    if "async_checkpoint" in inspect.signature(init).parameters:
        trainer_module.Trainer.__init__ = lambda self, *a, **kw: init(self, *a, **{**kw, "async_checkpoint": False})
os.makedirs("build", exist_ok=True)
with tempfile.TemporaryDirectory(dir="build") as run_dir:
    figures = getattr(chip_smoke, "phase_" + sys.argv[2])(run_dir)
figures = figures[-1] if isinstance(figures, tuple) else figures  # phase_train: (launches, figures)
keep = {k: figures[k] for k in ("step_ms", "host_ms", "images_per_s", "tokens_per_s", "peak_gb") if k in figures}
if "new" in figures:
    keep["busy"] = figures["new"]["busy"]
    keep["epoch_wall_ms"] = figures["new"]["wall_ms"]
print("FIGURES " + json.dumps(keep))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="vgg", choices=["vgg", "folder", "train"])
    parser.add_argument("--sync-saves", action="store_true", help="no background saves in either tree")
    parser.add_argument("first")
    parser.add_argument("second")
    args = parser.parse_args()
    runs = []
    for tree in (args.first, args.second, args.second, args.first):
        out = subprocess.run([sys.executable, "-c", _RUN, tree, args.phase,
                              "sync" if args.sync_saves else "as-is"], capture_output=True, text=True)
        figures = [line[len("FIGURES "):] for line in out.stdout.splitlines() if line.startswith("FIGURES ")]
        if out.returncode or not figures:
            print(out.stdout[-3000:], out.stderr[-3000:], sep="\n", file=sys.stderr)
            return 1
        runs.append({"tree": os.path.basename(os.path.normpath(tree)), **json.loads(figures[-1])})
        print(json.dumps(runs[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
