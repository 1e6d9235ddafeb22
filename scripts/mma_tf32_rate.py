#!/usr/bin/env python3
"""Measure what 3xTF32 on ``mma.sync`` can reach on the card.

    python3 scripts/mma_tf32_rate.py

Builds two small kernels against ``csrc/mma.cuh`` into ``build/mma_rate/``
(nvcc, sm_90a) and runs each on one block an SM: ``mma.sync`` m16n8k8 TF32
from registers (4, 8 or 16 independent accumulators a warp, 4, 8 or 16 warps
a block), and the 3xTF32 split of an fp32 value into big and small, once
with ``cvt.rna.tf32.f32`` (``Mma<float>::split``) and once with the integer
rounding ``ssd_scan_bwd.cu`` uses.  Prints SM cycles an instruction (from
``clock64`` in block 0), the TF32 rate of the mma from CUDA events, the
card's name and power limit, and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r'''
#include "mma.cuh"
using namespace repro_torch;
template <int NACC>
__global__ void mma_rate(float* out, int iters, long long* cyc) {
  float acc[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, threadIdx.x};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma_tf32(acc[j], a, b);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
template <bool CVT>
__global__ void split_rate(float* out, int iters, long long* cyc) {
  float x = threadIdx.x * 1.000123f;
  uint32_t acc = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t big, small;
      if (CVT) {
        big = to_tf32(x);
        small = to_tf32(x - __uint_as_float(big));
      } else {
        big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
        small = __float_as_uint(x - __uint_as_float(big));
      }
      acc += big ^ small;
      x += 1.f;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
extern "C" int run(int kind, int warps, int iters, float* out, long long* cyc, int blocks) {
  const dim3 grid(blocks), block(32 * warps);
  if (kind == 4) mma_rate<4><<<grid, block>>>(out, iters, cyc);
  if (kind == 8) mma_rate<8><<<grid, block>>>(out, iters, cyc);
  if (kind == 16) mma_rate<16><<<grid, block>>>(out, iters, cyc);
  if (kind == 1) split_rate<true><<<grid, block>>>(out, iters, cyc);
  if (kind == 2) split_rate<false><<<grid, block>>>(out, iters, cyc);
  return cudaGetLastError();
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_rate.cu").write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(out_dir / "libmma_rate.so"), str(out_dir / "mma_rate.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out_dir / "libmma_rate.so"))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.zeros(sms * 512, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    res = {"card": smi, "mma": {}, "split": {}}
    iters = 2000
    for kind in (4, 8, 16, 1, 2):
        for warps in (4, 8, 16):
            lib.run(kind, warps, iters, buf.data_ptr(), cyc.data_ptr(), sms)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            err = lib.run(kind, warps, iters, buf.data_ptr(), cyc.data_ptr(), sms)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
            ms = start.elapsed_time(end)
            if kind >= 4:
                per = int(cyc.item()) / (iters * kind * warps)
                tflops = sms * warps * iters * kind * 2 * 16 * 8 * 8 / ms / 1e9
                res["mma"][f"{kind}acc_{warps}warps"] = {"sm_cycles": per, "tf32_tflops": tflops}
                print(f"mma.sync m16n8k8 tf32, {kind} accumulators, {warps} warps: "
                      f"{per:.3f} SM cycles a mma, {tflops:.1f} TFLOP/s", flush=True)
            else:
                per = int(cyc.item()) / (iters * 16 * warps)
                name = "cvt.rna" if kind == 1 else "integer"
                res["split"][f"{name}_{warps}warps"] = {"sm_cycles": per}
                print(f"3xTF32 split by {name}, {warps} warps: {per:.3f} SM cycles a value",
                      flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
