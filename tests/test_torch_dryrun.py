"""The port's train step on a mesh of gloo ranks, and its dry run, on the
CPU.

The JAX package's ``test_sharded_train_step_matches_single_device``
(tests/test_parallel.py) on the port: one launch of four ranks steps
cnn_upscaler (features 8, depth 1, JAX's parameters carried across) once
on a ``data=4`` mesh and once on ``data=2, time=2``; the loss of each
equals the one-rank step's and JAX's single-device step's within 1e-5, and
the parameters after it equal the one-rank step's within 2 x lr (Adam's
first step moves a weight by about lr x sign(g), and a gradient near zero
may flip sign on rounding alone). Then ``python -m
video_enhancer_tpu_torch.parallel.dryrun --ranks 4 --device cpu``: four
gloo ranks on ``factor_devices(4)`` = (2, 2, 1), every check of it passing
and printing the JAX package's ``dryrun ok`` lines. Ranks are fresh
interpreters in which JAX, OpenCV, PyYAML and the JAX package cannot be
imported, one thread each, a ``file://`` store under the test's temporary
directory, bounded by a timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from video_enhancer_tpu.models import upscaler as jup
from video_enhancer_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_enhancer_tpu.runtime.weights import flatten_params as jflatten
from video_enhancer_tpu.train import step as jstep
from video_enhancer_tpu_torch.models import upscaler as tup
from video_enhancer_tpu_torch.parallel.mesh import local_mesh
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      params_from_jax)
from video_enhancer_tpu_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
TIMEOUT_S = 300
LR = 2e-4

RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
for name in ("jax", "jaxlib", "cv2", "yaml", "video_enhancer_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from video_enhancer_tpu_torch.models import upscaler
from video_enhancer_tpu_torch.parallel.mesh import make_mesh
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      params_from_jax)
from video_enhancer_tpu_torch.train.step import (make_optimizer,
                                                 make_train_step)

rank, work = int(sys.argv[2]), sys.argv[3]
data = dict(np.load(f"{work}/inputs.npz"))
params = params_from_jax({k: v for k, v in data.items() if "." in k})


def apply_clip(p, clip):
    b, t = clip.shape[:2]
    out = upscaler.apply(p, clip.reshape((b * t,) + clip.shape[2:]), scale=2)
    return out.reshape((b, t) + out.shape[1:])


out = {}
for name, dims in (("dp4", (4, 1, 1)), ("dts", (2, 2, 1))):
    mesh = make_mesh(*dims, rank=rank, init_file=f"{work}/store_{name}",
                     device="cpu", timeout_s=120)
    try:
        init_state, train_step, shard_batch = make_train_step(
            apply_clip, make_optimizer(), mesh)
        batch = shard_batch({"lr": data["lr"], "hr": data["hr"]})
        out[f"{name}:b"] = np.array(batch["lr"].shape[0])
        state, m = train_step(init_state(params), batch)
        out[f"{name}:loss"] = m["loss"].numpy()
        for k, v in flatten_params(state.params).items():
            out[f"{name}:{k}"] = v.detach().numpy()
    finally:
        mesh.destroy()
np.savez(f"{work}/out_{rank}.npz", **out)
"""


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=TIMEOUT_S,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _apply_clip(apply):
    def fn(p, clip):
        b, t = clip.shape[:2]
        out = apply(p, clip.reshape((b * t,) + clip.shape[2:]), scale=2)
        return out.reshape((b, t) + out.shape[1:])
    return fn


def test_sharded_train_step_matches_single_rank(tmp_path):
    jp = jax.jit(lambda k: jup.init(k, features=8, depth=1)[0])(
        jax.random.PRNGKey(0))
    g = np.random.default_rng(0)
    lr = g.random((8, 4, 32, 16, 3), np.float32)
    hr = g.random((8, 4, 64, 32, 3), np.float32)
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    np.savez(tmp_path / "inputs.npz", lr=lr, hr=hr, **flat)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(ROOT), str(r), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}) for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(RANKS)]

    mesh = jmake_mesh(data=1)
    init_state, train_step, shard_batch = jstep.make_train_step(
        _apply_clip(jup.apply), jstep.make_optimizer(), mesh)
    with jax.default_matmul_precision("highest"), mesh:
        _, m = train_step(init_state(jp), shard_batch(
            {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr)}))
    jax_loss = float(m["loss"])

    init_state, train_step, shard_batch = tstep.make_train_step(
        _apply_clip(tup.apply), tstep.make_optimizer(), local_mesh("cpu"))
    state, m = train_step(init_state(params_from_jax(flat)),
                          shard_batch({"lr": lr, "hr": hr}))
    single = m["loss"].item()
    after = {k: v.detach().numpy()
             for k, v in flatten_params(state.params).items()}
    assert abs(single - jax_loss) <= 1e-5
    for out in outs:
        assert int(out["dp4:b"]) == 2 and int(out["dts:b"]) == 4
        for name in ("dp4", "dts"):
            assert abs(float(out[f"{name}:loss"]) - single) <= 1e-5
            for k, v in after.items():
                np.testing.assert_allclose(out[f"{name}:{k}"], v, rtol=0,
                                           atol=2 * LR, err_msg=k)


def test_dryrun_at_four_gloo_ranks():
    out = _run([sys.executable, "-m",
                "video_enhancer_tpu_torch.parallel.dryrun", "--ranks",
                str(RANKS), "--device", "cpu"])
    lines = out.splitlines()
    assert lines[0] == "mesh: data=2 time=2 space=1"
    assert lines[1].startswith("dryrun ok: devices=4 flagship=fast_mamba_vsr "
                               "step=1 loss=")
    assert lines[2] == "dryrun ok: fsdp ditvr-small forward over 4 shards"
    for i, name in enumerate(("vsrm", "fast_mamba_vsr", "seedvr2", "ditvr"),
                             start=3):
        assert lines[i].startswith(f"dryrun ok: exact T-sharded {name} "
                                   f"max|Δ|=")
    assert lines[7].startswith("dryrun ok: T-sharded bissm vs fused kernel "
                               "(its plain version) max|Δ|=")
    assert lines[8].startswith("dryrun ok: exact T-sharded "
                               "fast_mamba_vsr[ssd mixer] max|Δ|=")
    assert lines[9].startswith("dryrun ok: ditvr-3b (3.06B params) splits "
                               "under FSDP over 4 shards")
    assert len(lines) == 10
