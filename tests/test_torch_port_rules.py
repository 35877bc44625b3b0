"""Guards of the port's ground rules.

* ``src/repro_torch`` and ``chip_smoke.py`` import no JAX and nothing of
  the JAX package ``repro`` (checked on the AST, and by importing the port
  in a fresh interpreter); nor do the card tests;
* constructors called without ``device=`` mean the card, and raise where
  there is none — there is no silent CPU fallback;
* a kernel wrapper runs its plain version only for CPU tensors, and counts
  a launch only when it launches; on ``meta`` tensors (the dry run) K5-K7
  return empty outputs and tally their work, K1 raises;
* ``chip_smoke.py`` fails, printing no result, without a card or without
  the repository around it.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import WorkSpec
from repro_torch.interop import (csr_from_arrays, lm_params_from_arrays,
                                 workspec_from_arrays)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_swa import kernel as FK
from repro_torch.kernels.segmm import kernel as SK
from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.models.lm import init_cache
from repro_torch.sparse import CSR, Graph, random_csr, suite_like_corpus

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "time_k2_forest.py",
    REPO / "tools" / "probe_gloo_cuda.py",
    REPO / "tools" / "time_flash_swa.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.module and _forbidden(
                node.module) else []
        elif isinstance(node, ast.Name):
            bad = [node.id] if node.id in ("jax", "jnp", "pl") else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} uses {bad}"


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import repro_torch.sparse, repro_torch.interop\n"
            "import repro_torch.kernels.spmv_merge.ops\n"
            "import repro_torch.kernels.segmm.ops, repro_torch.configs\n"
            "import repro_torch.models.moe, repro_torch.models.treelstm\n"
            "import repro_torch.sparse.wavefront, repro_torch.data.packing\n"
            "import repro_torch.kernels.flash_swa.ops\n"
            "import repro_torch.kernels.flash_swa.ref\n"
            "import repro_torch.models.lm, repro_torch.models.ssm\n"
            "import repro_torch.models.frontends\n"
            "import repro_torch.serve.decode, repro_torch.launch.serve\n"
            "import repro_torch.train.step, repro_torch.train.checkpoint\n"
            "import repro_torch.train.compress\n"
            "import repro_torch.train.quantized_opt\n"
            "import repro_torch.data.synthetic, repro_torch.launch.train\n"
            "import repro_torch.launch.mesh, repro_torch.train.pipeline\n"
            "import repro_torch.launch.specs, repro_torch.launch.roofline\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
            "import repro_torch.kernels.tally\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_card_tests_import_without_jax():
    """The cuda-marked tests run where only the port is installed."""
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "import test_torch_cuda\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_constructors_default_to_the_card():
    offsets = np.asarray([0, 1, 3], np.int32)
    makers = [
        lambda: resolve_device(),
        lambda: CSR.from_numpy(offsets, [0, 1, 0], [1.0, 2.0, 3.0], (2, 2)),
        lambda: CSR.from_dense(np.eye(3)),
        lambda: random_csr(8, 8, 16, skew=1.0),
        lambda: suite_like_corpus(smoke=True),
        lambda: Graph.from_dense(np.eye(3)),
        lambda: WorkSpec.from_segment_offsets(offsets, num_atoms=3),
        lambda: csr_from_arrays(offsets, [0, 1, 0], [1.0, 2.0, 3.0], (2, 2)),
        lambda: workspec_from_arrays(offsets),
        lambda: lm_params_from_arrays({"embed": np.zeros((2, 2)),
                                       "lm_head": np.zeros((2, 2)),
                                       "ln_f": {}, "layers": {}})["embed"],
        lambda: init_cache(get_config("h2o_danube3_4b").reduced(), 1, 4)["k"],
    ]
    for make in makers:
        if torch.cuda.is_available():
            made = make()
            if isinstance(made, list):           # the corpus: (name, CSR)
                made = made[0][1]
            device = made if isinstance(made, torch.device) else made.device
            assert device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert CSR.from_dense(np.eye(2), device="cpu").device.type == "cpu"


def test_wrappers_take_plain_version_only_on_cpu():
    before = dict(TK.LAUNCHES)
    csr = (torch.arange(3, dtype=torch.int32) * 2,
           torch.zeros(4, dtype=torch.int32), torch.ones(4), torch.ones(3))
    out = TK.spmv_merge_csr(*csr, num_rows=2, num_cols=3, block_items=128)
    assert out.shape == (2,) and TK.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        TK.spmv_merge_csr(*[t.to("meta") for t in csr], num_rows=2,
                          num_cols=3, block_items=128)
    seg_before = dict(SK.LAUNCHES)
    lhs, rhs = torch.ones(16, 8), torch.ones(2, 8, 8)
    experts = torch.tensor([0, 1], dtype=torch.int32)
    queue = (torch.tensor([1, 0], dtype=torch.int32),
             torch.tensor([2], dtype=torch.int32))
    assert (SK.segmented_matmul(lhs, rhs, experts, bm=8) == 8).all()
    assert (SK.segmented_matmul_chunked(lhs, rhs, experts, *queue, bm=8,
                                        max_chunks=2) == 8).all()
    assert SK.LAUNCHES == seg_before
    # meta tensors (the dry run): the kernel's output shape, no launch,
    # the kernel's flop tallied (repro_torch.kernels.tally)
    from repro_torch.kernels import tally
    tally.reset()
    meta = [t.to("meta") for t in (lhs, rhs, experts)]
    out = SK.segmented_matmul(*meta, bm=8)
    assert out.device.type == "meta" and out.shape == (16, 8)
    out = SK.segmented_matmul_chunked(*meta, *[q.to("meta") for q in queue],
                                      bm=8, max_chunks=2)
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert SK.LAUNCHES == seg_before
    assert tally.TALLY["flops"] == 2 * (2 * 16 * 8 * 8)
    swa_before = dict(FK.LAUNCHES)
    q = torch.ones(1, 16, 4, 8)
    kv = torch.ones(1, 16, 2, 8)
    assert torch.allclose(FK.flash_swa(q, kv, kv, window=8, qc=8), q)
    assert FK.LAUNCHES == swa_before
    out, lse = FK.flash_swa(q.to("meta"), kv.to("meta"), kv.to("meta"),
                            window=8, qc=8, return_lse=True)
    assert (out.device.type, out.shape, lse.shape) == ("meta", q.shape,
                                                       (1, 4, 16))
    assert FK.LAUNCHES == swa_before
    assert tally.TALLY["calls"]["flash_swa"] == 1


def test_build_needs_nvcc():
    if shutil.which("nvcc") or pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        assert _build.nvcc_path()
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()
    lib = _build.library_path(TK.SOURCES[0])
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


#: Two functions of ``cuobjdump -sass`` output, cut to the lines that
#: matter: the registers they name (uniform registers and ``R2UR`` aside),
#: the setmaxnreg instructions and the local loads and stores.
SASS = """
        Function : _Z8consumerv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   USETMAXREG.DEALLOC.CTAPOOL 0x18 ;
        /*0020*/                   USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xf0 ;
        /*0030*/                   R2UR UR4, R3 ;
        /*0040*/                   IMAD R231, -R5.reuse, |R12|, UR7 ;
        /*0050*/                   STL [R1+0x8], R3 ;
        /*0060*/                   LDL.LU R4, [R1+0x8] ;
        /*0070*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ ;
        Function : _Z8producerv
        /*0000*/                   MOV R7, UR5 ;
        /*0010*/                   EXIT ;
"""


def test_sass_summary_reads_registers_and_local_memory(monkeypatch):
    assert _build.sass_summary(SASS) == [
        ("_Z8consumerv", 232, ["USETMAXREG.DEALLOC.CTAPOOL 0x18",
                               "USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xf0"],
         1, 1),
        ("_Z8producerv", 8, [], 0, 0)]
    monkeypatch.setattr(_build, "cuobjdump_path", lambda: "")
    assert _build.sass_report(pathlib.Path("missing.so")) == ""


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs = [(alone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((REPO / "chip_smoke.py", REPO))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
