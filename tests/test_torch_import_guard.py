"""The PyTorch port imports nothing of JAX and nothing of the JAX package.

The import check runs in a subprocess: this test process already imported
jax (tests/conftest.py). There, ``jax``, ``flax``, ``optax`` and
``distributed_ba3c_tpu`` are blocked in ``sys.modules`` before every module
of the port is imported, so a transitive import of any of them fails.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "distributed_ba3c_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "distributed_ba3c_tpu")

_GUARDED_IMPORT = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import distributed_ba3c_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the run-keeping modules, by name
from distributed_ba3c_tpu_torch.train.callbacks import read_hyper_file
from distributed_ba3c_tpu_torch.train.checkpoint import CheckpointManager
from distributed_ba3c_tpu_torch.train.eval_tools import make_checkpoint_evaluator
# the sync trainer and its actor plane, by name
from distributed_ba3c_tpu_torch.actors.master import BA3CSimulatorMaster
from distributed_ba3c_tpu_torch.actors.simulator import SimulatorProcess, SimulatorMaster
from distributed_ba3c_tpu_torch.data.dataflow import TrainFeed
from distributed_ba3c_tpu_torch.data.staging import DeviceIngest, HostStagingRing
from distributed_ba3c_tpu_torch.envs.native import CppEnvServerProcess
from distributed_ba3c_tpu_torch.parallel.train_step import make_train_step
from distributed_ba3c_tpu_torch.telemetry.wire import DeltaTracker
from distributed_ba3c_tpu_torch.train.trainer import Trainer
from distributed_ba3c_tpu_torch.utils.serialize import pack_block
from distributed_ba3c_tpu_torch.utils.shm import ShmRing
# the V-trace trainer and the overlap, by name
from distributed_ba3c_tpu_torch.actors.simulator import SegStates
from distributed_ba3c_tpu_torch.actors.vtrace_master import VTraceSimulatorMaster
from distributed_ba3c_tpu_torch.data.dataflow import RolloutFeed, collate_rollout
from distributed_ba3c_tpu_torch.data.staging import collate_rollout_into, rollout_spec
from distributed_ba3c_tpu_torch.fused.overlap import make_block_grads, make_overlap_step
from distributed_ba3c_tpu_torch.ops.vtrace import vtrace_returns
from distributed_ba3c_tpu_torch.parallel.vtrace_step import make_vtrace_train_step
leaked = sorted(
    m for m in sys.modules
    if sys.modules[m] is not None and m.split(".")[0] in {blocked!r}
)
assert not leaked, leaked
print(len(names))
"""


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _GUARDED_IMPORT.format(blocked=BLOCKED)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 28  # every module walked


@pytest.mark.parametrize(
    "path",
    sorted(os.path.relpath(p, REPO) for p in _port_sources())
    + ["chip_smoke.py"],
)
def test_source_names_no_blocked_import(path):
    roots = set(_imported_roots(os.path.join(REPO, path)))
    assert not roots & set(BLOCKED), (path, sorted(roots & set(BLOCKED)))


def test_kernel_sources_are_in_the_package():
    """Every CUDA source the build step knows sits in csrc/."""
    from distributed_ba3c_tpu_torch.ops import _build

    for name in _build._SIGNATURES:
        assert os.path.isfile(os.path.join(_build.CSRC, f"{name}.cu")), name
