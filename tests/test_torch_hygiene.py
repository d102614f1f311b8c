"""Import hygiene of the port and the kernel wrappers' dispatch rules.

- Importing the port (every module of the slice) never imports jax, nor
  the JAX package.
- A wrapper sends CPU tensors to its plain twin and never to the kernel.
- For CUDA tensors a wrapper calls its launcher, never the twin; when the
  build fails or the launch returns a CUDA error it raises. There is no
  fallback either way. Here, without a card, "CUDA" tensors are meta
  tensors and the build and launcher are stubs.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from racing_slam_tpu_torch.ops.kernels import _build
from racing_slam_tpu_torch.ops.kernels import attention as k6
from racing_slam_tpu_torch.ops.kernels import frontend as k1
from racing_slam_tpu_torch.ops.kernels import match as k2
from racing_slam_tpu_torch.ops.kernels import match_banded as k5
from racing_slam_tpu_torch.ops.kernels import motion_ba as k3
from racing_slam_tpu_torch.ops.kernels import structure_ba as k4

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "racing_slam_tpu_torch", "racing_slam_tpu_torch.device", "racing_slam_tpu_torch.ops.se3",
    "racing_slam_tpu_torch.ops.camera", "racing_slam_tpu_torch.ops.image",
    "racing_slam_tpu_torch.ops.corners", "racing_slam_tpu_torch.ops.descriptors",
    "racing_slam_tpu_torch.ops.matching", "racing_slam_tpu_torch.ops.ba",
    "racing_slam_tpu_torch.ops.triangulation", "racing_slam_tpu_torch.ops.essential",
    "racing_slam_tpu_torch.ops.ransac", "racing_slam_tpu_torch.ops.kernels._build",
    "racing_slam_tpu_torch.ops.kernels.frontend", "racing_slam_tpu_torch.ops.kernels.match",
    "racing_slam_tpu_torch.ops.kernels.match_banded", "racing_slam_tpu_torch.parallel",
    "racing_slam_tpu_torch.parallel.refine",
    "racing_slam_tpu_torch.ops.kernels.motion_ba",
    "racing_slam_tpu_torch.ops.kernels.structure_ba", "racing_slam_tpu_torch.ops.kernels.attention",
    "racing_slam_tpu_torch.models", "racing_slam_tpu_torch.models.lightglue",
    "racing_slam_tpu_torch.models.superpoint", "racing_slam_tpu_torch.slam.config",
    "racing_slam_tpu_torch.slam.state", "racing_slam_tpu_torch.slam.frontend",
    "racing_slam_tpu_torch.slam.pipeline", "racing_slam_tpu_torch.utils.synthetic",
    "racing_slam_tpu_torch.utils.convert", "racing_slam_tpu_torch.utils.metrics",
    "racing_slam_tpu_torch.utils.video",
]


def test_importing_the_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'racing_slam_tpu']\n"
        "assert not ref, ref\n"
        "import torch\n"
        "assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for path in [*(REPO / "racing_slam_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        src = path.read_text()
        assert "import jax" not in src and "from jax" not in src, path
        assert "from racing_slam_tpu." not in src and "import racing_slam_tpu." not in src, path


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# (module, wrapper name, twin name, C entry point, args builder, kwargs)
CASES = {
    "K1": (k1, "corner_frontend_fused", "corner_frontend_fused_reference", "slam_frontend",
           lambda: (_meta((48, 64)), _meta((48, 64))), {}),
    "K2": (k2, "guided_match_stage1", "guided_match_stage1_reference", "slam_guided_match",
           lambda: (_meta((64, 2)), _meta((64,), torch.bool), _meta((64, 8, 128), torch.bfloat16),
                    _meta((64, 8), torch.bool), _meta((96, 2)), _meta((96, 128)),
                    _meta((96,), torch.bool)), dict(radius_px=28.0)),
    "K3": (k3, "motion_ba_lm", "motion_ba_lm_reference", "slam_motion_ba",
           lambda: (_meta((6,)), _meta((96, 2)), _meta((96, 3)), _meta((96,), torch.bool)),
           dict(fx=480.0, cx=320.0, cy=240.0, max_iters=10, huber_delta=0.005)),
    "K4": (k4, "structure_ba_lm", "structure_ba_lm_reference", "slam_structure_ba",
           lambda: (_meta((32, 3)), _meta((32, 3)), _meta((128, 3)), _meta((128, 8), torch.int64),
                    _meta((128, 8, 2)), _meta((128, 8), torch.bool), _meta((128,), torch.bool),
                    _meta((), torch.int64)),
           dict(fx=480.0, cx=320.0, cy=240.0, max_iters=10, huber_delta=0.005)),
    "K5": (k5, "guided_match_stage1_banded", "guided_match_stage1_banded_reference",
           "slam_guided_match_banded",
           lambda: (_meta((512, 2)), _meta((512,), torch.bool),
                    _meta((512, 8, 128), torch.bfloat16), _meta((512, 8), torch.bool), _meta((1024, 2)), _meta((1024, 128)),
                    _meta((1024,), torch.bool), _meta((2,), torch.int32),
                    _meta((), torch.int32)), dict(radius_px=28.0)),
    "K6": (k6, "flash_mha", "flash_mha_reference", "slam_flash_mha",
           lambda: (_meta((64, 4, 32)), _meta((96, 4, 32)), _meta((96, 4, 32)),
                    _meta((96,), torch.bool)), {}),
}


class FakeLib:
    def __init__(self, entry, err=0):
        self.calls = []
        self.entry = entry

        def launcher(*args):
            self.calls.append(args)
            return err

        setattr(self, entry, launcher)
        self.slam_error_string = lambda e: b"stub error"
        # Buffer sizes the K4 and K6 wrappers ask for before a launch.
        self.slam_structure_ba_scratch_bytes = lambda P, O, cluster: 0
        self.slam_flash_mha_workspace_bytes = lambda Kq, Kk, H, dh, chunks: 1 << 20


@pytest.fixture
def as_cuda(monkeypatch):
    """Meta tensors stand for CUDA tensors; the stream handle is 0."""
    monkeypatch.setattr(_build, "device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "stream", lambda device: 0)


def _no_twin(monkeypatch, mod, twin):
    def forbidden(*a, **k):
        raise AssertionError("the twin must not run for CUDA tensors")

    monkeypatch.setattr(mod, twin, forbidden)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_tensors_go_to_the_launcher(monkeypatch, as_cuda, name):
    mod, fn, twin, entry, make, kw = CASES[name]
    lib = FakeLib(entry)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    _no_twin(monkeypatch, mod, twin)
    before = mod.launches
    getattr(mod, fn)(*make(), **kw)
    assert len(lib.calls) == 1 and mod.launches == before + 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_launch_error_raises(monkeypatch, as_cuda, name):
    mod, fn, twin, entry, make, kw = CASES[name]
    monkeypatch.setattr(_build, "lib", lambda: FakeLib(entry, err=700))
    _no_twin(monkeypatch, mod, twin)
    before = mod.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        getattr(mod, fn)(*make(), **kw)
    assert mod.launches == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_failure_raises(monkeypatch, as_cuda, name):
    mod, fn, twin, entry, make, kw = CASES[name]

    def failed_build():
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(_build, "lib", failed_build)
    _no_twin(monkeypatch, mod, twin)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        getattr(mod, fn)(*make(), **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_go_to_the_twin(monkeypatch, name):
    mod, fn, twin, entry, make, kw = CASES[name]

    def no_lib():
        raise AssertionError("the kernel must not be built for CPU tensors")

    monkeypatch.setattr(_build, "lib", no_lib)
    calls = []
    monkeypatch.setattr(mod, twin, lambda *a, **k: calls.append(a) or "twin")
    args = [torch.zeros(t.shape, dtype=t.dtype) for t in make()]
    assert getattr(mod, fn)(*args, **kw) == "twin" and len(calls) == 1


def test_wrapper_checks_operands(monkeypatch, as_cuda):
    monkeypatch.setattr(_build, "lib", lambda: FakeLib("slam_motion_ba"))
    args = list(CASES["K3"][4]())
    args[1] = _meta((96, 2), torch.float64)
    with pytest.raises(TypeError, match="kp_uv"):
        k3.motion_ba_lm(*args, **CASES["K3"][5])
    args[1] = _meta((96, 2))
    args[2] = _meta((96, 4))
    with pytest.raises(ValueError, match="point_xyz"):
        k3.motion_ba_lm(*args, **CASES["K3"][5])
    args[2] = _meta((96, 3))
    args[1] = _meta((2, 96)).T
    with pytest.raises(ValueError, match="contiguous"):
        k3.motion_ba_lm(*args, **CASES["K3"][5])


def test_mixed_or_unknown_devices_raise():
    with pytest.raises(ValueError, match="several device types"):
        _build.device_kind(torch.zeros(2), _meta((2,)))
    with pytest.raises(ValueError, match="no kernel"):
        _build.device_kind(_meta((2,)))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / _build.LIB_NAME).exists()
