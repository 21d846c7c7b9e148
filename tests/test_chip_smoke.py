"""Rehearsal of chip_smoke.py's phases at tiny widths on the CPU, and
its refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mobius_rag_tpu.models.encoder import EncoderConfig  # noqa: E402


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_phase_encoder_tiny():
    texts = chip_smoke.corpus_texts()
    assert len(texts) >= 200  # "a few hundred chunks" of the packaged corpus
    model = chip_smoke.phase_encoder(EncoderConfig.tiny(), texts[:24], n_ref=4)
    assert model.cfg.out_dim == 256


def test_phase_served_tiny():
    from mobius_rag_tpu.models.encoder import EncoderModel

    chip_smoke.phase_served(EncoderModel(EncoderConfig.tiny(), seed=0))


def test_phase_exact_tiny():
    chip_smoke.phase_exact(n=3000, nq=64)


def test_phase_proj_tiny():
    out = chip_smoke.phase_proj(n=8000, nq=8)
    assert out["recall_full"] >= chip_smoke.PROJ_FULL_PROBE_FLOOR
    assert set(out["gated"]) == {0, 1, 2}


def test_fused_topk_agree_ties():
    a = {"idx": np.array([[1, 2, 3]]), "rerank": np.array([[0.9, 0.5, 0.4]])}
    tie = {"idx": np.array([[1, 2, 4]]),
           "rerank": np.array([[0.9, 0.5, 0.40001]])}
    off = {"idx": np.array([[1, 2, 4]]), "rerank": np.array([[0.9, 0.5, 0.45]])}
    assert chip_smoke._fused_topk_agree(a, a) == 0
    assert chip_smoke._fused_topk_agree(a, tie) == 0
    assert chip_smoke._fused_topk_agree(a, off) == 1


@pytest.fixture
def gpu_card():
    """The card's nvidia-smi label, or a skip: decided when the test
    runs (a child process, no JAX), never at import."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU here (nvidia-smi not found)")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        pytest.skip(f"no NVIDIA GPU here: {r.stderr.strip()}")
    return r.stdout.strip()


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    """The whole smoke run on the card, in a child process free of this
    suite's CPU-only environment."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "MRAG_EMBED_DIM",
                        "MRAG_INITIAL_CAPACITY", "MRAG_LEXICAL_BUCKETS",
                        "JAX_COMPILATION_CACHE_DIR")}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = r.stdout.strip().splitlines()[-1]
    assert '"ok": true' in last and '"platform": "gpu"' in last, last
