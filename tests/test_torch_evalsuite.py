"""The port's eval suite (video_enhancer_tpu_torch/train/evalsuite.py)
against the JAX package's on the CPU, with the bundled weights.

Tolerances: ``bundled_gain`` within 1e-3 dB of JAX's (measured ~4e-6):
cnn_upscaler on both families at 2 seeds, vsrm on ``alt`` at 1 seed. The
report writer and the CLI write only where they are told (a temporary
file), and the committed weights/QUALIFICATION.json keeps its bytes.
"""

import hashlib
import json

import pytest

from video_enhancer_tpu.train import evalsuite as jeval
from video_enhancer_tpu_torch.runtime import qualification as tqual
from video_enhancer_tpu_torch.train import evalsuite as teval

REPORT = teval.WEIGHTS_DIR / "QUALIFICATION.json"


def _digest():
    return hashlib.sha256(REPORT.read_bytes()).hexdigest()


@pytest.mark.parametrize("name,family,n_seeds", [
    ("cnn_upscaler", "ind", 2), ("cnn_upscaler", "alt", 2),
    ("vsrm", "alt", 1)])
def test_bundled_gain_matches_jax(name, family, n_seeds):
    got = teval.bundled_gain(name, family, n_seeds=n_seeds, device="cpu")
    ref = jeval.bundled_gain(name, family, n_seeds=n_seeds)
    assert abs(got - ref) <= 1e-3, (got, ref)


def test_report_and_cli_write_only_where_told(tmp_path, monkeypatch, capsys):
    before = _digest()
    dest = tmp_path / "q.json"
    rep = teval.write_qualification_report(
        path=dest, n_seeds=1, models=("cnn_upscaler",), device="cpu")
    on_disk = json.loads(dest.read_text())
    assert on_disk == rep and rep["n_seeds"] == 1
    assert set(rep["models"]["cnn_upscaler"]) == {"ind", "alt"}

    # the CLI's --report writes where $VETPU_QUALIFICATION points
    env_dest = tmp_path / "env.json"
    monkeypatch.setenv("VETPU_QUALIFICATION", str(env_dest))
    assert tqual.report_path() == env_dest
    rep2 = teval.write_qualification_report(
        n_seeds=1, models=("cnn_upscaler",), device="cpu")
    assert json.loads(env_dest.read_text()) == rep2 == rep

    rc = teval._main(["cnn_upscaler", "--family", "alt", "--n-seeds", "1",
                      "--device", "cpu", "--compare-npz",
                      str(teval.WEIGHTS_DIR / "cnn_upscaler_2x.npz")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["verdict"] == "ok"
    assert out["gain_db"] == out["snapshot_gain_db"] \
        == rep["models"]["cnn_upscaler"]["alt"]
    with pytest.raises(ValueError, match="unknown eval family"):
        teval.frames_for("xyz")
    with pytest.raises(ValueError, match="unknown model"):
        teval.model_entry("nope")
    assert _digest() == before


def test_report_needs_a_destination_outside_the_jax_package(monkeypatch,
                                                            capsys):
    """With neither ``path=`` nor ``$VETPU_QUALIFICATION`` the writer and
    ``--report`` refuse before measuring anything, as they do for a
    destination in the JAX package; the committed report keeps its
    bytes."""
    before = _digest()
    monkeypatch.delenv("VETPU_QUALIFICATION", raising=False)
    with pytest.raises(SystemExit) as e:
        teval._main(["--report", "--n-seeds", "1", "--device", "cpu"])
    assert e.value.code == 2
    assert "VETPU_QUALIFICATION" in capsys.readouterr().err
    with pytest.raises(ValueError, match="VETPU_QUALIFICATION"):
        teval.write_qualification_report(n_seeds=1, device="cpu")
    with pytest.raises(ValueError, match="writes nothing under"):
        teval.write_qualification_report(path=REPORT, n_seeds=1,
                                         device="cpu")
    monkeypatch.setenv("VETPU_QUALIFICATION", str(REPORT))
    with pytest.raises(SystemExit):
        teval._main(["--report", "--n-seeds", "1", "--device", "cpu"])
    assert _digest() == before


def test_fp32_eval_hands_the_ssd_kernel_operands_it_reads_in_place(
        monkeypatch):
    """vsrm's fp32 eval takes the SSD kernel (``kernels=True``): its x
    must have dense heads and x, B and C evenly strided rows, as the CUDA
    wrapper demands (an fp32 depthwise conv once handed it a transposed
    view, which only the card showed)."""
    import torch

    from video_enhancer_tpu_torch import kernels
    from video_enhancer_tpu_torch.ops import ssd

    seen = []
    real = ssd.ssd_shared_kernel

    def check_layout(x, dt, A, Bm, Cm, chunk=256, reverse=False):
        P = x.shape[3]
        assert x.stride(3) == 1 and x.stride(2) == P, x.stride()
        for t, name in ((x.flatten(2), "x"), (Bm, "Bm"), (Cm, "Cm")):
            kernels.row_stride(t, name)
        seen.append(x.dtype)
        return real(x, dt, A, Bm, Cm, chunk=chunk, reverse=reverse)

    monkeypatch.setattr(ssd, "ssd_shared_kernel", check_layout)
    _, apply_fn, _, _ = teval._raw_model_entry("vsrm")
    from video_enhancer_tpu_torch.models import vsrm

    params = vsrm.init(torch.Generator().manual_seed(0), dim=64,
                       num_blocks=1, scale=4)
    with torch.inference_mode():
        apply_fn(params, torch.rand(1, 2, 8, 8, 3))
    assert seen and set(seen) == {torch.float32}
