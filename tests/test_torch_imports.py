"""The port stands alone: no module of cop5615_gossip_protocol_tpu_torch, and
not chip_smoke.py, imports JAX or the JAX package; and its entry points go
to the GPU unless the CPU is asked for by name, raising when there is no
GPU instead of quietly running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch import bench
from cop5615_gossip_protocol_tpu_torch.cli import main
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, rng
from cop5615_gossip_protocol_tpu_torch.utils.device import resolve_device

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "cop5615_gossip_protocol_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_jax_imports_anywhere_in_the_port():
    files = sorted((ROOT / "cop5615_gossip_protocol_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    # Only modules the port's import adds count: an interpreter's startup
    # hooks may have loaded others already.
    code = (
        "import sys; before = set(sys.modules); "
        "import cop5615_gossip_protocol_tpu_torch.cli, "
        "cop5615_gossip_protocol_tpu_torch.bench, "
        "cop5615_gossip_protocol_tpu_torch.parallel.pool2_sharded, "
        "cop5615_gossip_protocol_tpu_torch.parallel.fused_sharded, "
        "cop5615_gossip_protocol_tpu_torch.parallel.fused_hbm_sharded, "
        "cop5615_gossip_protocol_tpu_torch.parallel.fused_imp_hbm_sharded, "
        "cop5615_gossip_protocol_tpu_torch.ops.scatter, "
        "cop5615_gossip_protocol_tpu_torch.models.reference; "
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cop5615_gossip_protocol_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; these pin the behaviour without one")


def test_entry_points_refuse_without_a_gpu(no_gpu, capsys):
    cfg = SimConfig(n=100, algorithm="gossip", delivery="pool")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(build_topology("full", 100), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--n", "100"])
    assert main(["100", "full", "gossip", "--delivery", "pool"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_chip_smoke_fails_without_a_gpu(no_gpu):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    # CPU tensors run the plain version and launch nothing; anything the
    # kernels do not take is refused before any launch.
    n, layout = 1000, fused_pool.build_pool_layout(1000)
    key = rng.PRNGKey(0)
    keys = fused.round_keys(key, 0, 4)
    offs = fused_pool.round_offsets(key, 0, 4, 2, n)
    planes = (torch.zeros(layout.rows, 128, dtype=torch.int32),) * 3
    before = fused_pool.gossip_pool_chunk.launches
    _, ex = fused_pool.gossip_pool_chunk(planes, keys, offs, 0, 4, n=n, target=n,
                                         rumor_target=10, suppress=False)
    assert int(ex) == 4 and fused_pool.gossip_pool_chunk.launches == before
    with pytest.raises(ValueError, match="pool_size"):
        fused_pool.gossip_pool_chunk(
            planes, keys, fused_pool.round_offsets(key, 0, 4, 32, n), 0, 4, n=n,
            target=n, rumor_target=10, suppress=False)
    with pytest.raises(ValueError, match="state plane"):
        fused_pool.gossip_pool_chunk(
            (planes[0].float(),) + planes[1:], keys, offs, 0, 4, n=n, target=n,
            rumor_target=10, suppress=False)
    with pytest.raises(ValueError, match=r"offs must lie in \[1, 999\]"):
        fused_pool.gossip_pool_chunk(
            planes, keys, torch.full_like(offs, n), 0, 4, n=n, target=n,
            rumor_target=10, suppress=False)
    with pytest.raises(ValueError, match="host-drawn streams"):
        fused_pool.gossip_pool_chunk(
            planes, keys.to("meta"), offs, 0, 4, n=n, target=n,
            rumor_target=10, suppress=False)
    with pytest.raises(ValueError, match="engine='fused' unavailable"):
        run(build_topology("full", 100),
            SimConfig(n=100, delivery="pool", pool_size=32, engine="fused"),
            device="cpu")


def test_unported_config_fields_name_roadmap_items():
    for kw, item in (({"fault_rate": 0.1}, "A6"), ({"dup_rate": 0.1}, "A7b"),
                     ({"termination": "global"}, "A6"),
                     ({"dtype": "float64"}, "A12"), ({"halo_dma": "on"}, "A10"),
                     ({"topology": "full", "delivery": "matmul"}, "A7b"),
                     ({"topology": "imp3d", "delivery": "matmul"}, "A7b")):
        fields = {"n": 100, "algorithm": "push-sum", "delivery": "pool", **kw}
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            SimConfig(**fields)
