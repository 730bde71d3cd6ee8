"""Checkpoint / resume across the two packages, on the CPU.

The port writes and reads the JAX package's ``.npz`` format: a JAX
checkpoint resumed by the port and a port checkpoint resumed by JAX both
restore the accumulator bit for bit and continue exactly as a renderer
handed that state in memory; a fingerprint mismatch starts fresh; a
resumed run on the port's plain path equals an uninterrupted one bit for
bit.

The port's writer deflates each member in chunks on a thread pool into
the archive ``np.savez_compressed`` writes: with the chunk lowered to a
test size, a save reads back whole in ``zipfile``, ``np.load`` and both
packages' loaders, member for member as numpy's, within 0.5% of its
size; at a member's chunk boundaries too; a failed save leaves the
previous checkpoint; a save runs on the pool only where a member has
more than one chunk, and the tracing spans it.
"""

import dataclasses
import io
import json
import os
import struct
import threading
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import NOTHING_TRACED, jax_cfg, port_cfg
from cpuperformanceraytracer_tpu.core.vecmath import Vec3 as JVec3
from cpuperformanceraytracer_tpu.io import checkpoint as jckpt
from cpuperformanceraytracer_tpu.render.driver import (
    OfflineRenderer as JaxRenderer,
)
from cpuperformanceraytracer_tpu.render.driver import RenderState
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.io import checkpoint as ckpt
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.utils import profiling

FRAMES = 2


@pytest.fixture(scope="module")
def jcfg():
    return jax_cfg(width=32, height=8, bounces=1, scene="cornell_box",
                   env_mode="none", rng="counter", backend="xla",
                   num_frames=FRAMES, warmup_frames=0)


@pytest.fixture(scope="module")
def jax_renderer(jcfg):
    return JaxRenderer(jcfg, silent=True)


def _port(jcfg, **kw):
    return OfflineRenderer(port_cfg(jcfg, **kw), silent=True)


def _np(v3):
    return np.stack([np.asarray(c) for c in v3])


def test_fingerprints_and_config_mapping(jcfg):
    pcfg = port_cfg(jcfg)
    assert ckpt.image_fingerprint(pcfg) == jckpt.image_fingerprint(jcfg)
    assert jckpt.image_fingerprint(pcfg) == ckpt.image_fingerprint(jcfg)
    mapped = RenderConfig.from_dict(dataclasses.asdict(jcfg))
    assert mapped == pcfg.replace(backend="cuda")   # "xla" is dropped
    assert RenderConfig.from_dict(dataclasses.asdict(pcfg)) == pcfg


def test_jax_checkpoint_resumed_by_port(jcfg, jax_renderer, tmp_path):
    path = str(tmp_path / "jax.npz")
    jr = jax_renderer
    jr.resume(None)                 # a fresh start
    jr.run(checkpoint_path=path, checkpoint_every=FRAMES)
    saved = _np(jr.state.accum)

    r = _port(jcfg)
    r.resume(path)
    assert r.frame == FRAMES
    np.testing.assert_array_equal(r.accum.numpy(), saved)
    twin = _port(jcfg)
    twin.accum, twin.frame = torch.as_tensor(saved.copy()), FRAMES
    r.step()
    twin.step()
    assert torch.equal(r.accum, twin.accum)
    jr.step()                      # JAX's own next frame, strict (cornell)
    np.testing.assert_allclose(r.accum.numpy(), _np(jr.state.accum),
                               rtol=1e-4, atol=1e-5)


def test_port_checkpoint_resumed_by_jax(jcfg, jax_renderer, tmp_path):
    path = str(tmp_path / "port.npz")
    r = _port(jcfg)
    r.run(checkpoint_path=path, checkpoint_every=FRAMES)
    saved = r.accum.numpy().copy()

    jr = jax_renderer
    jr.resume(path)
    assert jr.state.frame == FRAMES
    np.testing.assert_array_equal(_np(jr.state.accum), saved)
    jr.step()
    resumed = _np(jr.state.accum)
    jr.state = RenderState(accum=JVec3(*(jnp.asarray(c) for c in saved)),
                           frame=FRAMES)
    jr.step()
    np.testing.assert_array_equal(resumed, _np(jr.state.accum))
    r.step()
    np.testing.assert_allclose(r.accum.numpy(), resumed, rtol=1e-4,
                               atol=1e-5)


def test_fingerprint_mismatch_starts_fresh(jcfg, tmp_path):
    path = str(tmp_path / "c.npz")
    r = _port(jcfg)
    r.run(checkpoint_path=path, checkpoint_every=1)
    other = _port(jcfg, spp=2)
    other.resume(path)
    assert other.frame == 0 and not other.accum.any()
    accum, frame = jckpt.resume_or_fresh(path, jcfg.replace(bounces=2))
    assert frame == 0 and not np.asarray(accum.x).any()
    missing = _port(jcfg)
    missing.resume(str(tmp_path / "absent.npz"))
    assert missing.frame == 0


def test_resumed_run_equals_uninterrupted(tmp_path):
    """4 frames saved every 2, resumed in a new renderer for 2 more:
    bit-equal to 6 frames in one run (bilinear env, spp 2: the A -> E ->
    F route)."""
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import (
        texture_from_array,
    )

    tex = texture_from_array(gradient_sky(32, 16))
    cfg = RenderConfig(width=32, height=8, bounces=1, spp=2, rng="counter",
                       env_sampling="bilinear", backend="torch",
                       warmup_frames=1, num_frames=4)
    path = str(tmp_path / "r.npz")
    a = OfflineRenderer(cfg, texture=tex, silent=True)
    a.run(checkpoint_path=path, checkpoint_every=2)
    b = OfflineRenderer(cfg.replace(num_frames=2), texture=tex, silent=True)
    b.resume(path)
    assert b.frame == 4
    b.run()
    whole = OfflineRenderer(cfg.replace(num_frames=6), texture=tex,
                            silent=True)
    whole.run()
    assert b.frame == whole.frame == 6
    assert torch.equal(b.accum, whole.accum)


# a (3, 256, 512) accumulator: 512 KiB a plane, 8 chunks of 64 KiB
CHUNK = 1 << 16
MEMBERS = ("version", "frame", "r", "g", "b", "config")


def _accumulator(h: int = 256, w: int = 512) -> np.ndarray:
    """A smooth image with grain, on a grid of 1/256: it deflates to a
    third, more than a render's planes (about a half), so a chunk's
    cost in bytes weighs more here."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(x / 37.0) * np.cos(y / 23.0)
    grain = rng.standard_normal((3, h, w)).astype(np.float32)
    return (np.round((base + 0.05 * grain) * 256) / 256).astype(np.float32)


def _cfg(acc: np.ndarray) -> RenderConfig:
    return RenderConfig(width=acc.shape[2], height=acc.shape[1],
                        backend="torch")


def _numpy_save(path, acc, frame, cfg) -> None:
    np.savez_compressed(path, version=ckpt.FORMAT_VERSION, frame=frame,
                        r=acc[0], g=acc[1], b=acc[2],
                        config=json.dumps(dataclasses.asdict(cfg)))


def _npy_size(a) -> int:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.tell()


def _directory(path) -> tuple:
    """The zip's central directory and end records, field for field, but
    each compressed size and offset read only as whether it is zip64's
    mark (the two deflate streams differ in length), and each extra as
    its header (which zip64 values it holds)."""
    data = open(path, "rb").read()
    end = list(struct.unpack(zipfile.structEndArchive, data[-22:]))
    zip64 = data[-42:-38] == zipfile.stringEndArchive64Locator
    start = (struct.unpack(zipfile.structEndArchive64, data[-98:-42])[9]
             if zip64 else end[6])
    records = []
    for _ in range(end[3]):
        r = list(struct.unpack(zipfile.structCentralDir,
                               data[start:start + 46]))
        name, extra = r[12], r[13]
        records.append((r[:10] + [r[10] == 0xFFFFFFFF] + r[11:18]
                        + [r[18] == 0xFFFFFFFF],
                        data[start + 46:start + 46 + name],
                        data[start + 46 + name:start + 50 + name]))
        start += 46 + name + extra + r[14]
    end[6] = end[6] == 0xFFFFFFFF
    return records, zip64, end


def _same_planes(got, acc) -> bool:
    return all(np.array_equal(np.asarray(g).view(np.uint32),
                              a.view(np.uint32)) for g, a in zip(got, acc))


@pytest.mark.parametrize("zip64_limit", [None, 100],
                         ids=["as_numpy", "past_the_zip64_limit"])
def test_parallel_save_round_trip(zip64_limit, tmp_path, monkeypatch):
    """With the zip64 limit lowered (``zipfile``'s too, for numpy's
    archive), every size and offset but the first needs the zip64
    extras and the directory the zip64 end records."""
    monkeypatch.setattr(ckpt, "CHUNK", CHUNK)
    if zip64_limit is not None:
        monkeypatch.setattr(ckpt, "_ZIP64_LIMIT", zip64_limit)
        monkeypatch.setattr(zipfile, "ZIP64_LIMIT", zip64_limit)
    acc = _accumulator()
    assert _npy_size(acc[0]) > 4 * CHUNK
    cfg = _cfg(acc)
    path, plain = str(tmp_path / "c.npz"), str(tmp_path / "numpy.npz")
    ckpt.save_checkpoint(path, torch.from_numpy(acc), 9, cfg)
    _numpy_save(plain, acc, 9, cfg)

    with zipfile.ZipFile(path) as z, zipfile.ZipFile(plain) as want:
        assert z.testzip() is None          # every member's CRC read back
        assert z.namelist() == [f"{m}.npy" for m in MEMBERS]
        for got, ref in zip(z.infolist(), want.infolist()):
            assert got.compress_type == zipfile.ZIP_DEFLATED
            assert z.read(got) == want.read(ref)
    with np.load(path, allow_pickle=False) as z:
        assert int(z["version"]) == ckpt.FORMAT_VERSION
        assert int(z["frame"]) == 9
        assert _same_planes((z["r"], z["g"], z["b"]), acc)
        assert str(z["config"]) == json.dumps(dataclasses.asdict(cfg))
    back, frame, saved = ckpt.load_checkpoint(path)
    assert frame == 9 and saved == cfg and _same_planes(back, acc)
    jback, jframe, jsaved = jckpt.load_checkpoint(path)
    assert jframe == 9 and (jsaved.width, jsaved.height) == (512, 256)
    assert _same_planes((jback.x, jback.y, jback.z), acc)
    size, ref = (tmp_path / "c.npz").stat().st_size, (
        tmp_path / "numpy.npz").stat().st_size
    assert abs(size - ref) <= 0.005 * ref
    assert _directory(path) == _directory(plain)
    assert _directory(path)[1] == (zip64_limit is not None)


def _count_deflates(monkeypatch) -> list:
    """The threads that deflate chunks from now on, one name a chunk."""
    deflate, names = ckpt._Member.deflate, []

    def counted(member, a, b):
        names.append(threading.current_thread().name)
        return deflate(member, a, b)

    monkeypatch.setattr(ckpt._Member, "deflate", counted)
    return names


@pytest.mark.parametrize("chunks, short", [(3, 0), (5, 1), (1, 1)],
                         ids=["multiple", "a_byte_short", "under_one"])
def test_a_plane_at_the_chunk_boundaries(chunks, short, tmp_path,
                                         monkeypatch):
    """The plane's member is ``chunks`` chunks, the last ``short`` bytes
    short of whole."""
    acc = _accumulator(16, 64)
    n = _npy_size(acc[0])
    chunk = (n + short) // chunks
    assert chunk * chunks == n + short
    monkeypatch.setattr(ckpt, "CHUNK", chunk)
    deflated = _count_deflates(monkeypatch)
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, torch.from_numpy(acc), 4, _cfg(acc))
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
    with np.load(path) as z:
        assert _same_planes((z["r"], z["g"], z["b"]), acc)
        assert int(z["frame"]) == 4
    config = json.dumps(dataclasses.asdict(_cfg(acc)))
    sizes = [_npy_size(np.asanyarray(v)) for v in
             (ckpt.FORMAT_VERSION, 4, acc[0], acc[1], acc[2], config)]
    want = sum(-(-size // chunk) for size in sizes)
    assert len(deflated) == want


@pytest.mark.parametrize("fault", ["worker", "write"])
def test_a_failed_save_leaves_the_previous_checkpoint(fault, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(ckpt, "CHUNK", CHUNK)
    acc = _accumulator()
    path = tmp_path / "c.npz"
    ckpt.save_checkpoint(str(path), torch.from_numpy(acc), 3, _cfg(acc))
    before = path.read_bytes()

    if fault == "worker":
        deflate = ckpt._Member.deflate

        def failing(member, a, b):
            if member.name == b"g.npy" and a == 2 * CHUNK:
                raise RuntimeError("planted")
            return deflate(member, a, b)

        monkeypatch.setattr(ckpt._Member, "deflate", failing)
    else:
        def failing(f, entries):
            f.write(b"PK\x03\x04")
            raise RuntimeError("planted")

        monkeypatch.setattr(ckpt, "_write_zip", failing)
    with pytest.raises(RuntimeError, match="planted"):
        ckpt.save_checkpoint(str(path), torch.from_numpy(acc * 2), 4,
                             _cfg(acc))
    assert path.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz"]


def test_the_save_is_counted_and_spanned(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "CHUNK", CHUNK)
    acc = torch.from_numpy(_accumulator())
    cfg = _cfg(acc.numpy())
    path = str(tmp_path / "c.npz")
    deflated = _count_deflates(monkeypatch)
    ckpt.save_checkpoint(path, acc, 1, cfg)
    assert len(deflated) > len(MEMBERS)
    assert all(name.startswith("checkpoint") for name in deflated)
    assert ckpt._executor()._max_workers == len(os.sched_getaffinity(0))

    deflated.clear()
    small = torch.from_numpy(_accumulator(8, 16))
    ckpt.save_checkpoint(path, small, 1, _cfg(small.numpy()))
    assert deflated == [threading.current_thread().name] * len(MEMBERS)

    with profiling.trace(str(tmp_path / "t")):
        ckpt.save_checkpoint(path, acc, 2, cfg)
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    spans = {e["name"]: e for e in events["traceEvents"]
             if e.get("name", "").startswith("checkpoint.")}
    assert set(spans) == {"checkpoint.save", "checkpoint.copy",
                          "checkpoint.deflate", "checkpoint.write"}
    save = spans["checkpoint.save"]
    for name in ("checkpoint.copy", "checkpoint.deflate",
                 "checkpoint.write"):
        child = spans[name]
        assert save["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= save["ts"] + save["dur"]
    counters = json.loads((tmp_path / "t" / profiling.COUNTERS_FILE)
                          .read_text())
    assert counters == NOTHING_TRACED
