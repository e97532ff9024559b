"""The port's tests hold to one CPU thread (``tests/torch_cpu.py``).

Every ``tests/test_torch_*.py`` imports ``torch_cpu``, read from the
sources, so that a new port test file cannot forget it; and inside a test
torch runs one intra-op thread and the processes it starts inherit
``OMP_NUM_THREADS=1``.
"""

import ast
import glob
import os

import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {alias.name for node in tree.body if isinstance(node, ast.Import)
            for alias in node.names}


def test_every_port_test_file_is_found():
    assert len(FILES) >= 29, FILES


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_port_test_file_imports_torch_cpu(path):
    assert "torch_cpu" in _imports(path), (
        f"{os.path.basename(path)} does not import torch_cpu at module level")


def test_one_thread_here_and_in_children():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["MKL_NUM_THREADS"] == "1"
