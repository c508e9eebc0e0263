"""The memory prediction against the card's caching allocator (``cuda`` marker; skips
without a card; imports no JAX, so it runs on the card's machine with ``--noconftest``):
``scripts/torch_memory_probe.py --device cuda``, whose single step's transient bytes must
equal ``max_memory_allocated``'s to the byte, and whose oversized batch must be refused with
a recommendation that fits."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [(), ("--inject-oversize",)])
def test_memory_probe_on_the_card(extra):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prediction is held against the caching allocator's max_memory_allocated")
    done = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_memory_probe.py"), "--device", "cuda",
                           *extra], capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
