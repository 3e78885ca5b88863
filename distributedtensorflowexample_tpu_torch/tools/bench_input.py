"""bench_input — the native C++ host loader against numpy (the JAX
package's ``bench_input.py``, over the port's ``native/``).

  python -m distributedtensorflowexample_tpu_torch.tools.bench_input \\
      --out /tmp/records/BENCH_input_cpu_r16.json

The native runtime (``native/dataio.cc`` through ``native/loader.py``)
backs the host-fed input path (``--device_data off``): IDX and CIFAR
byte parsing, and the per-step batch gather with the crop and flip.
Four stages run both implementations on the same inputs:

- ``cifar_parse``: CIFAR-10 binary records -> float32 images, labels;
- ``idx_parse``: IDX image bytes -> float32 images;
- ``gather_augment``: gather a batch of float32 rows, crop and flip;
- ``gather_augment_u8``: the same on a uint8 split (its baseline is the
  float32 native path: what uint8 storage buys on top of the runtime).

Each stage asserts that the two paths are bit-identical (the random
draws are made once, outside the timed region) before it times them.
Host only: no card.  One JSON line per stage, ``{"metric", "value" (the
native rate), "unit", "vs_baseline" (native over numpy), "detail"}``,
with ``detail.repeats`` the native rate of each repeat and
``detail.device`` the host's CPU model; ``--out`` also writes them.  If
the native library cannot be built, the tool exits 1 by name and
measures nothing.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time

import numpy as np

from distributedtensorflowexample_tpu_torch import native
from distributedtensorflowexample_tpu_torch.data.cifar10 import (
    _augment_numpy, _draw)
from distributedtensorflowexample_tpu_torch.data.dequant import (
    U8_UNIT_SCALE, affine_numpy)
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
    describe_device)

REPEATS = 3


def _times(fn, iters: int) -> list[float]:
    """Seconds per call of ``fn``, one mean over ``iters`` calls for each
    of the ``REPEATS`` repeats."""
    out = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out.append((time.perf_counter() - t0) / iters)
    return out


def _line(metric: str, work: float, unit: str, native_s: list,
          base_s: list, detail: dict) -> dict:
    """A stage's record: the best native rate, its speedup over the best
    baseline rate, and each repeat's native rate."""
    return {"metric": metric, "value": round(work / min(native_s), 1),
            "unit": unit,
            "vs_baseline": round(min(base_s) / min(native_s), 3),
            "detail": {**detail, "platform": "cpu",
                       "repeats": [round(work / t, 1) for t in native_s],
                       "omp_threads": native.omp_threads()}}


def bench_cifar_parse(n_records: int = 10000) -> dict:
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, size=n_records * 3073,
                      dtype=np.uint8).tobytes()
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3073)

    def numpy_parse():
        nhwc = rows[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        # The canonical f32 1/255 multiply (data/dequant.py): a division
        # rounds differently on 126 of the 256 byte values.
        return (nhwc.astype(np.float32) * U8_UNIT_SCALE,
                rows[:, 0].astype(np.int32))

    ni, nl = native.parse_cifar(raw)
    pi, pl = numpy_parse()
    np.testing.assert_array_equal(ni, pi)
    np.testing.assert_array_equal(nl, pl)
    mb = len(raw) / 1e6
    t_native = _times(lambda: native.parse_cifar(raw), 3)
    t_numpy = _times(numpy_parse, 3)
    return _line("cifar_parse_native_mb_per_sec", mb, "MB/sec", t_native,
                 t_numpy, {"records": n_records,
                           "numpy_mb_per_sec": round(mb / min(t_numpy), 1)})


def bench_idx_parse(n: int = 60000) -> dict:
    rng = np.random.RandomState(1)
    body = rng.randint(0, 256, size=n * 28 * 28, dtype=np.uint8)
    raw = struct.pack(">IIII", 2051, n, 28, 28) + body.tobytes()

    def numpy_parse():
        data = np.frombuffer(raw, dtype=np.uint8, count=n * 28 * 28,
                             offset=16)
        return data.reshape(n, 28, 28, 1).astype(np.float32) * U8_UNIT_SCALE

    np.testing.assert_array_equal(native.parse_idx_images(raw),
                                  numpy_parse())
    mb = len(raw) / 1e6
    t_native = _times(lambda: native.parse_idx_images(raw), 3)
    t_numpy = _times(numpy_parse, 3)
    return _line("idx_parse_native_mb_per_sec", mb, "MB/sec", t_native,
                 t_numpy, {"images": n,
                           "numpy_mb_per_sec": round(mb / min(t_numpy), 1)})


def bench_gather_augment(n_src: int = 50000, batch: int = 256) -> dict:
    """The per-step host work of an augmented CIFAR run (``--device_data
    off``): gather the batch's rows, reflect-pad-4 crop, flip.  Native
    does it in one OpenMP pass; numpy gathers, then augments."""
    rng = np.random.RandomState(2)
    src = rng.rand(n_src, 32, 32, 3).astype(np.float32)
    idx = rng.randint(0, n_src, size=batch).astype(np.int64)
    ys, xs, flips = _draw(np.random.RandomState(3), batch)

    def native_fused():
        return native.gather_augment(src, idx, ys, xs, flips)

    def numpy_path():
        return _augment_numpy(src[idx], ys, xs, flips)

    np.testing.assert_array_equal(native_fused(), numpy_path())
    t_native = _times(native_fused, 20)
    t_numpy = _times(numpy_path, 20)
    return _line("gather_augment_native_images_per_sec", batch,
                 "images/sec", t_native, t_numpy,
                 {"batch": batch, "source_rows": n_src,
                  "numpy_images_per_sec": round(batch / min(t_numpy), 1)})


def bench_gather_augment_u8(n_src: int = 50000, batch: int = 256) -> dict:
    """The same fused gather, crop and flip on a uint8-resident split
    (4x fewer bytes moved).  The baseline is the float32 NATIVE path."""
    rng = np.random.RandomState(4)
    src8 = rng.randint(0, 256, size=(n_src, 32, 32, 3), dtype=np.uint8)
    src32 = affine_numpy(src8, "unit")
    idx = rng.randint(0, n_src, size=batch).astype(np.int64)
    ys, xs, flips = _draw(np.random.RandomState(5), batch)

    # The uint8 result dequantizes to exactly the float32 path's output.
    np.testing.assert_array_equal(
        affine_numpy(native.gather_augment(src8, idx, ys, xs, flips),
                     "unit"),
        native.gather_augment(src32, idx, ys, xs, flips))
    t_u8 = _times(lambda: native.gather_augment(src8, idx, ys, xs, flips),
                  20)
    t_f32 = _times(lambda: native.gather_augment(src32, idx, ys, xs,
                                                 flips), 20)
    return _line("gather_augment_native_u8_images_per_sec", batch,
                 "images/sec", t_u8, t_f32,
                 {"batch": batch, "source_rows": n_src,
                  "f32_images_per_sec": round(batch / min(t_f32), 1),
                  "bytes_per_image_u8": 3072, "bytes_per_image_f32": 12288})


def run_stages(sizes: dict | None = None) -> list[dict]:
    """The four stages' lines, each with ``detail.device`` (the host);
    ``sizes`` maps a stage function's name to its keyword sizes."""
    sizes = sizes or {}
    device = describe_device("cpu")
    lines = []
    for stage in (bench_cifar_parse, bench_idx_parse, bench_gather_augment,
                  bench_gather_augment_u8):
        line = stage(**sizes.get(stage.__name__, {}))
        line["detail"]["device"] = device
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="",
                   help="also write the JSON lines here (BENCH_input_* "
                        "family)")
    args = p.parse_args(argv)
    if not native.available():
        print("bench_input: the native loader is unavailable (no g++ or "
              "its build failed): nothing to measure against numpy",
              file=sys.stderr, flush=True)
        return 1
    obs_ledger.maybe_begin("bench_input")
    lines = run_stages()
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    obs_ledger.end_global(rc=0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
