"""The port's application layer against the JAX package's: the
experiment logger (``utils/logger.py``), checkpoints (``utils/checkpoint.py``),
the progress reporter (``core/logger.py``), ``to_bitmap_u8``, ``run``'s
logging, checkpointing and resume (``app/optim.py``), and the launcher
(``app/run_experiments.py``).

Tolerances: the PNG bytes, ``metrics.jsonl``, the parameter dumps and the
progress lines equal JAX's exactly; ``to_bitmap_u8`` within one count of
256 (PyTorch's and XLA's float32 ``pow`` may round a value across a
count's edge); checkpoints round-trip bit for bit, across packages too;
a resumed ``run`` equals an uninterrupted one bit for bit (the CPU's
sums are deterministic).
"""
import io
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.ad import optimizers as opt_j
from epsm_mitsuba3_tpu.app import run_experiments as rx_j
from epsm_mitsuba3_tpu.core import logger as clog_j
from epsm_mitsuba3_tpu.core import spectrum as spec_j
from epsm_mitsuba3_tpu.utils import checkpoint as ckpt_j
from epsm_mitsuba3_tpu.utils import logger as log_j

from epsm_mitsuba3_torch.ad import optimizers as opt_t
from epsm_mitsuba3_torch.app import optim as optim_t
from epsm_mitsuba3_torch.app import run_experiments as rx_t
from epsm_mitsuba3_torch.app.exp import cornellbox, human
from epsm_mitsuba3_torch.core import logger as clog_t
from epsm_mitsuba3_torch.core import spectrum as spec_t
from epsm_mitsuba3_torch.utils import checkpoint as ckpt_t
from epsm_mitsuba3_torch.utils import logger as log_t

from torch_threads import one_torch_thread  # noqa: F401


def _image(seed=0, h=12, w=10):
    """A seeded HDR image with values below 0, in [0, 1] and above 1."""
    return np.random.default_rng(seed).uniform(-0.2, 1.4, (h, w, 3)).astype(
        np.float32)


def _files(root):
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(r, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_to_bitmap_u8_matches_jax():
    x = np.concatenate([_image(1).ravel(), np.linspace(0, 1, 4097,
                                                       dtype=np.float32)])
    got = spec_t.to_bitmap_u8(x)
    ref = np.asarray(spec_j.to_bitmap_u8(jnp.asarray(x)))
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    t = spec_t.to_bitmap_u8(torch.from_numpy(x))
    assert t.dtype == torch.uint8 and np.array_equal(t.numpy(), got)


def test_write_png_bytes_equal_jax(tmp_path):
    arr = (np.random.default_rng(2).random((7, 9, 3)) * 255).astype(np.uint8)
    for name, a in (("rgb", arr), ("gray", arr[..., 0])):
        log_t._write_png(str(tmp_path / f"t_{name}"), a)
        log_j._write_png(str(tmp_path / f"j_{name}.png"), a)
        t = (tmp_path / f"t_{name}.png").read_bytes()
        assert t == (tmp_path / f"j_{name}.png").read_bytes()
        assert t.startswith(b"\x89PNG")


def _no_video(monkeypatch, module):
    """The module's video backends as if cv2 and imageio were missing."""
    def missing(*a, **k):
        raise ImportError("no video backend")
    monkeypatch.setattr(module, "_Cv2Video", missing)
    monkeypatch.setattr(module, "_ImageioVideo", missing)


def _log_session(module, root, image_of):
    lg = module.Logger(str(root), "exp")
    for it in range(3):
        lg.add_image("render", image_of(_image(it)), step=it, type="video")
        lg.add_metric(it, loss=1.0 / (it + 1), theta=np.float32(0.25 * it))
        lg.add_params(it, {"pose": image_of(np.full(4, it, np.float32))})
    lg.add_image("snap", image_of(_image(5)), step=3, type="image")
    lg.save_img("final", image_of(_image(6)))
    lg.save_npy("final", image_of(_image(6)))
    lg.close()


def test_logger_frames_mode_files_equal_jax(tmp_path, monkeypatch):
    """Without a video backend (the card's machine has neither cv2 nor
    imageio) each video frame is a numbered PNG: the port's files, from
    tensors, equal JAX's, from arrays, byte for byte (the PNGs, where
    ``to_bitmap_u8`` agrees, which the seeded images let it), and the
    parameter dumps hold the same values."""
    _no_video(monkeypatch, log_t)
    _no_video(monkeypatch, log_j)
    _log_session(log_t, tmp_path / "t", torch.from_numpy)
    _log_session(log_j, tmp_path / "j", jnp.asarray)
    ft, fj = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(ft) == sorted(fj)
    assert sum(k.startswith(os.path.join("exp", "images", "render_"))
               for k in ft) == 3
    assert os.path.join("exp", "images", "snap_00003.png") in ft
    assert not any(k.endswith(".mp4") for k in ft)
    for k in ft:
        a, b = ft[k], fj[k]
        if os.sep + "params" + os.sep in k:
            pa = np.load(a, allow_pickle=True).item()
            pb = np.load(b, allow_pickle=True).item()
            assert set(pa) == set(pb) == {"pose"}
            assert np.array_equal(pa["pose"], np.asarray(pb["pose"]))
        elif k.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), k
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), k
    lines = open(ft[os.path.join("exp", "metrics.jsonl")]).read().splitlines()
    assert [json.loads(x) for x in lines] == [
        {"it": i, "loss": 1.0 / (i + 1), "theta": 0.25 * i} for i in range(3)]


def test_logger_video_mode(tmp_path):
    """With a video backend (cv2 or imageio) a stream is one mp4 and no
    frames; without one, three numbered frames."""
    probe = log_t._open_video(str(tmp_path / "probe.mp4"), 4, 4, 24.0)
    if probe is not None:
        probe.close()
    lg = log_t.Logger(str(tmp_path / "log"))
    for it in range(3):
        lg.add_image("render", torch.from_numpy(_image(it)), step=it)
    lg.close()
    files = _files(tmp_path / "log")
    frames = [k for k in files if "render_" in k]
    if probe is not None:
        assert os.path.getsize(files["render.mp4"]) > 0 and not frames
    else:
        assert len(frames) == 3 and "render.mp4" not in files


# -- checkpoints --------------------------------------------------------------

def _stepped(module, tensor):
    o = module.Adam(lr=0.1)
    o["x"] = tensor(np.asarray([1.0, 2.0, -3.0], np.float32))
    o["y"] = tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    for s in range(3):
        r = np.random.default_rng(s)
        o.step({"x": tensor(r.normal(size=3).astype(np.float32)),
                "y": tensor(r.normal(size=(2, 3)).astype(np.float32))})
    return o


def _same_optimizer(a, b):
    for k in ("x", "y"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        for sa, sb in zip(a.state[k], b.state[k]):
            assert np.array_equal(np.asarray(sa), np.asarray(sb)), k
        assert a.t[k] == b.t[k] == 3


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_optimizer_checkpoint_loads_in_the_port(tmp_path, writer):
    """``save_optimizer`` of either package, ``load_optimizer`` of the
    port: the variables, both moments and t bit for bit, the iteration
    to resume at the saved one + 1; and the port's files as JAX's."""
    src = (_stepped(opt_t, torch.from_numpy) if writer == "port"
           else _stepped(opt_j, jnp.asarray))
    (ckpt_t if writer == "port" else ckpt_j).save_optimizer(
        str(tmp_path), 7, src, seed=3)
    dst = opt_t.Adam(lr=0.1)
    dst["x"], dst["y"] = torch.zeros(3), torch.zeros((2, 3))
    assert ckpt_t.load_optimizer(str(tmp_path), dst) == 8
    _same_optimizer(dst, src)
    assert all(isinstance(v, torch.Tensor) for v in dst.variables.values())
    assert ckpt_t.latest_step(str(tmp_path)) == 7
    meta = json.load(open(tmp_path / "opt_7.json"))
    assert meta == {"it": 7, "seed": 3, "extra": {"t": {"x": 3, "y": 3},
                                                  "lr": 0.1}}
    keys = sorted(np.load(tmp_path / "opt_7.npz").files)
    assert keys == ["state.x.0", "state.x.1", "state.y.0", "state.y.1",
                    "var.x", "var.y"]


def test_port_checkpoint_loads_in_jax(tmp_path):
    src = _stepped(opt_t, torch.from_numpy)
    ckpt_t.save_optimizer(str(tmp_path), 4, src)
    dst = opt_j.Adam(lr=0.1)
    dst["x"], dst["y"] = jnp.zeros(3), jnp.zeros((2, 3))
    assert ckpt_j.load_optimizer(str(tmp_path), dst) == 5
    _same_optimizer(dst, src)


def test_load_optimizer_without_checkpoint(tmp_path):
    o = opt_t.Adam(lr=0.1)
    o["x"] = torch.ones(2)
    assert ckpt_t.load_optimizer(str(tmp_path), o) == 0
    assert ckpt_t.latest_step(str(tmp_path)) is None
    assert ckpt_t.load(str(tmp_path)) is None
    assert torch.equal(o["x"], torch.ones(2))


def test_save_and_load_checkpoint_across_packages(tmp_path):
    """``save`` / ``load``: theta and a nested optimizer state, written by
    the port and read by both packages, and written by JAX and read by
    the port; the flat state in JAX's leaf order (dict keys sorted)."""
    theta = {"b": np.arange(3, dtype=np.float32), "a": np.ones((2, 2))}
    state = {"m": (np.full(2, 1.0), np.full(3, 2.0)), "a": [np.zeros(1)]}
    ckpt_t.save(str(tmp_path / "t"), 5, {k: torch.from_numpy(v)
                                         for k, v in theta.items()},
                opt_state=state, seed=9, extra={"note": "x"})
    ckpt_j.save(str(tmp_path / "j"), 5, theta, opt_state=state, seed=9,
                extra={"note": "x"})
    for path in ("t", "j"):
        for load in (ckpt_t.load, ckpt_j.load):
            it, th, opt, meta = load(str(tmp_path / path))
            assert it == 5 and meta["seed"] == 9
            assert meta["extra"] == {"note": "x"}
            assert sorted(th) == ["a", "b"]
            for k in theta:
                assert np.array_equal(th[k], theta[k])
            assert sorted(opt) == ["opt_0", "opt_1", "opt_2"]
            assert np.array_equal(opt["opt_0"], np.zeros(1))
            assert np.array_equal(opt["opt_2"], np.full(3, 2.0))
    assert ckpt_t.latest_step(str(tmp_path / "t")) == 5


# -- progress -----------------------------------------------------------------

@pytest.mark.parametrize("module", [clog_t, clog_j])
def test_progress_reporter_lines(module, monkeypatch):
    """The same text as JAX's for the same clock: a 30-column bar, the
    percentage, elapsed and estimated seconds, the extra text, a newline
    at the end, and updates closer than ``min_interval`` dropped."""
    clock = iter([100.0, 101.0, 101.2, 104.0])
    monkeypatch.setattr(module.time, "time", lambda: next(clock))
    out = io.StringIO()
    p = module.ProgressReporter("manifold", 4, stream=out)
    p.update(1, "a")
    p.update(2, "b")          # 0.2 s later: dropped
    p.update(4, "c")
    assert out.getvalue() == (
        "\rmanifold [=======                       ]  25.0% (elapsed   "
        "1.0s, eta   3.0s) a"
        "\rmanifold [==============================] 100.0% (elapsed   "
        "4.0s, eta   0.0s) c\n")


def test_log_levels():
    assert clog_t._logger.name == "epsm_mitsuba3_torch"
    for k in ("Trace", "Debug", "Info", "Warn", "Error"):
        assert getattr(clog_t.LogLevel, k) == getattr(clog_j.LogLevel, k)
    level = clog_t._logger.level
    try:
        clog_t.set_log_level(clog_t.LogLevel.Error)
        assert clog_t._logger.level == clog_t.LogLevel.Error
        clog_t.Log(clog_t.LogLevel.Info, "dropped %d", 1)
    finally:
        clog_t.set_log_level(level)


# -- run: logging, checkpoints, resume ---------------------------------------

def _box(**kw):
    exp = cornellbox.make(resolution=8, spp=1, match_res=8, max_depth=2,
                          device="cpu", **kw)
    exp["gt_spp"] = 2
    return exp


def test_run_resumed_equals_uninterrupted(tmp_path):
    """``run("manifold_caustic")`` on cornellbox at 8^2: 2 iterations with
    a checkpoint after each, then ``resume`` up to 4, against 4
    uninterrupted iterations, bit for bit; the logger's parameter dumps
    and checkpoints on the way."""
    log_dir = str(tmp_path / "run")
    _, full = optim_t.run("manifold_caustic", _box(), iters=4,
                          verbose=False)
    opt2, first = optim_t.run("manifold_caustic", _box(), iters=2,
                              log_dir=log_dir, checkpoint_every=1,
                              verbose=False)
    files = _files(log_dir)
    assert {"params/param0.npy", "params/param1.npy", "ckpt/opt_0.npz",
            "ckpt/opt_1.npz", "ckpt/latest", "metrics.jsonl"} <= set(files)
    assert ckpt_t.latest_step(os.path.join(log_dir, "ckpt")) == 1
    dump = np.load(files["params/param1.npy"], allow_pickle=True).item()
    for k in dump:
        assert np.array_equal(dump[k], first[1][k])
    opt4, rest = optim_t.run("manifold_caustic", _box(), iters=4,
                             log_dir=log_dir, resume=True,
                             checkpoint_every=1, verbose=False)
    assert len(first) == 2 and len(rest) == 2
    for got, ref in zip(first + rest, full):
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k
    assert opt4.t == {k: 4 for k in full[0]}
    assert ckpt_t.latest_step(os.path.join(log_dir, "ckpt")) == 3


def test_run_progress_bar(capsys):
    """``verbose`` (the default) writes the progress bar to standard
    error."""
    optim_t.run("manifold_caustic", _box(), iters=1)
    err = capsys.readouterr().err
    assert err.startswith("\rmanifold_caustic [") and "100.0%" in err


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["manifold"], ["manifold_shadow", "human"], ["manifold", "teapot"],
    ["bogus", "human", "--small"]])
def test_run_experiments_argument_errors_as_jax(argv, capsys):
    """Fewer than two arguments: the usage and 1; an unknown method
    (``manifold_shadow`` too) or experiment: SystemExit with JAX's text."""
    def outcome(main):
        try:
            return ("return", main(list(argv)))
        except SystemExit as e:
            return ("exit", str(e))

    got, ref = outcome(rx_t.main), outcome(rx_j.main)
    assert got == ref
    if len(argv) < 2:
        assert got == ("return", 1)
        assert "METHOD" in capsys.readouterr().out
    assert rx_t.EXPERIMENTS == rx_j.EXPERIMENTS
    assert rx_t.METHODS == rx_j.METHODS


@pytest.fixture
def small_human(monkeypatch):
    """``human.make`` cut below ``--small`` (16^2, spp 1, match 16, a
    2-spp ground truth), ``optim.run`` to 1 iteration; the calls to
    ``render`` counted."""
    make, run, render = human.make, optim_t.run, optim_t.render
    renders = []

    def small_make(**kw):
        assert kw["resolution"] == 64 and kw["spp"] == 8
        kw.update(resolution=16, spp=1, match_res=16)
        exp = make(**kw)
        exp["gt_spp"] = 2
        return exp

    def counted(*a, **kw):
        renders.append(kw.get("integrator"))
        return render(*a, **kw)

    monkeypatch.setattr(human, "make", small_make)
    monkeypatch.setattr(optim_t, "run", lambda *a, **kw: run(
        *a, **{**kw, "iters": 1}))
    monkeypatch.setattr(optim_t, "render", counted)
    return renders


def test_run_experiments_human_small_end_to_end(tmp_path, monkeypatch,
                                                small_human, capsys):
    monkeypatch.chdir(tmp_path)
    assert rx_t.main(["manifold", "human", "--small", "--device",
                      "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("final: |pose|=")
    files = _files(tmp_path)
    assert "results/human/manifold/params/param0.npy" in files
    assert "results/human/manifold/metrics.jsonl" in files
    dump = np.load(files["results/human/manifold/params/param0.npy"],
                   allow_pickle=True).item()
    assert dump["pose"].shape == (72,) and np.isfinite(dump["pose"]).all()
    assert [r["type"] for r in small_human] == ["path", "manifold"]


@pytest.mark.parametrize("method", ["prb", "path", "prb_reparam"])
def test_run_experiments_refuses_3_channel_methods(method, tmp_path,
                                                   monkeypatch, small_human):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="OT loss"):
        rx_t.main([method, "human", "--small", "--device", "cpu"])
    assert small_human == []
