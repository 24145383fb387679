#!/usr/bin/env python3
"""How does kernel C's f32 body meet the card? (one card)

    python3 scripts/torch_flash_f32_probe.py

1. How the tensor cores read an f32 word as tf32. A one-warpgroup kernel
   (built here from ``PROBE_SOURCE`` against ``csrc/hopper.cuh``) runs
   ``WgmmaTf32<64>::rs`` and ``::ss`` and ``WgmmaTf32<128>::rs`` with one
   operand holding f32 words whose low 13 bits are set (ties, halves,
   random words) and the other 1.0: each product reads back the tf32 value
   of the word, held against truncation, rna and rne. The same kernel
   multiplies random 64 x 8 and 8 x N tiles exact in tf32 and compares them
   with the host's product, which checks the fragment layouts and the
   128-byte-swizzled descriptors of ``hopper.cuh`` apart from any kernel.
2. The body's build: ptxas's registers, spills and stack for each f32
   instantiation, and the SASS counts (``cuobjdump -sass`` of the built
   library) of HGMMA, UTMALDG, HMMA, WARPGROUP.DEPBAR and local loads and
   stores in each.
3. The body's error: at chip_smoke.py's phase-3 shapes (4 x 512 causal at
   D 128, ViT-L/16's 32 x 197 at D 64), the kernel, the f32 plain version
   and the tile emulation of tests/test_torch_flash_f32_tiles.py (with the
   hi rule read in 1), each against an f64 reference of the same inputs.

Prints one JSON line per part and the card's name and power limit, and
writes them to ``chiprun_out/flash_f32_probe.json``. Exits non-zero if the
layout products differ from the host's or the card reads a word by none
of the three rules.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402
from gofr_tpu_torch.ops import cuda  # noqa: E402

PROBE_SOURCE = r"""
#include <cstdint>
#include "hopper.cuh"

// D (64 x N) = A (64 x 8) * B (8 x N), tf32 in, f32 out, one warpgroup.
// a: A row-major; b: B as [n][k] (K-major, as the body's K and Vt planes).
// mode 0: A from registers, N = 64; 1: A from shared memory, N = 64;
// 2: A from registers, N = 128.
template <int N>
__device__ void product(const float* a, const float* b, float* d_out, int mode,
                        unsigned char* a_s, unsigned char* b_s) {
  for (int i = threadIdx.x; i < 64 * 32; i += 128) reinterpret_cast<float*>(a_s)[i] = 0.f;
  for (int i = threadIdx.x; i < N * 32; i += 128) reinterpret_cast<float*>(b_s)[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {
    const int r = i / 8, k = i % 8;
    *reinterpret_cast<float*>(a_s + r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4) = a[i];
  }
  for (int i = threadIdx.x; i < N * 8; i += 128) {
    const int n = i / 8, k = i % 8;
    *reinterpret_cast<float*>(b_s + n * 128 + (((k >> 2) ^ (n & 7)) << 4) + (k & 3) * 4) = b[i];
  }
  gofr::fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp + gid;
  uint32_t af[4] = {__float_as_uint(a[r0 * 8 + c]), __float_as_uint(a[(r0 + 8) * 8 + c]),
                    __float_as_uint(a[r0 * 8 + c + 4]), __float_as_uint(a[(r0 + 8) * 8 + c + 4])};
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint64_t bd = gofr::sw128_desc(gofr::smem_addr(b_s));
  gofr::wgmma_fence();
  if constexpr (N == 64) {
    if (mode == 1) gofr::WgmmaTf32<64>::ss(d, gofr::sw128_desc(gofr::smem_addr(a_s)), bd, 0);
    else gofr::WgmmaTf32<64>::rs(d, af, bd, 0);
  } else {
    gofr::WgmmaTf32<128>::rs(d, af, bd, 0);
  }
  gofr::wgmma_commit();
  gofr::wgmma_wait<0>();
  gofr::fence_regs(d);
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e)
      d_out[(r0 + 8 * (e >> 1)) * N + 8 * j + 2 * c + (e & 1)] = d[4 * j + e];
}

__global__ void __launch_bounds__(128) probe_kernel(const float* a, const float* b, float* d,
                                                    int mode) {
  __shared__ __align__(1024) unsigned char a_s[64 * 128];
  __shared__ __align__(1024) unsigned char b_s[128 * 128];
  if (mode == 2) product<128>(a, b, d, mode, a_s, b_s);
  else product<64>(a, b, d, mode, a_s, b_s);
}

extern "C" int gofr_tf32_probe(const void* a, const void* b, void* d, int mode) {
  probe_kernel<<<1, 128>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                           static_cast<float*>(d), mode);
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
"""
MODES = {"rs_n64": (0, 64), "ss_n64": (1, 64), "rs_n128": (2, 128)}
PROBE_DIR = cuda.BUILD / "probe"


def build_probe() -> ctypes.CDLL:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = PROBE_DIR / "tf32_probe.cu", PROBE_DIR / "libtf32_probe.so"
    src.write_text(PROBE_SOURCE)
    subprocess.run([cuda.nvcc(), *cuda.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(cuda.CSRC), str(src), "-o", str(lib)], check=True)
    probe = ctypes.CDLL(str(lib))
    probe.gofr_tf32_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    probe.gofr_tf32_probe.restype = ctypes.c_int
    return probe


def tf32_rne(x):
    """To nearest, ties to even (finite x)."""
    import torch

    bits = x.view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def probe_words(torch) -> "torch.Tensor":
    """64 f32 words whose low 13 bits matter: below, at and above half a
    tf32 ulp, ties on even and odd, both signs, and random words."""
    one = 1.0
    ulp = 2.0 ** -10  # a tf32 ulp at 1
    special = [one + ulp / 2 - 2 ** -23, one + ulp / 2, one + ulp / 2 + 2 ** -23, one + 3 * ulp / 2,
               one + ulp - 2 ** -23, 1.5 + ulp / 2, 3.0 + 2 ** -21, 0.7 + 2 ** -24]
    words = special + [-w for w in special]
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 31)
    rand = torch.randn(64 - len(words), generator=gen)
    return torch.cat([torch.tensor(words, dtype=torch.float32), rand])


def read_rule(torch, probe) -> dict:
    """For each form and operand, which rule reproduces the value the
    tensor cores read of every probe word."""
    from test_torch_flash_f32_tiles import tf32_rna, tf32_trunc

    words = probe_words(torch)
    rules = {"trunc": tf32_trunc(words), "rna": tf32_rna(words), "rne": tf32_rne(words)}
    out = {}
    for form, (mode, n) in MODES.items():
        for operand in ("a", "b"):
            if operand == "b" and mode == 1:
                continue  # B is read the same way whatever A's source
            a = torch.zeros(64, 8)
            b = torch.zeros(n, 8)
            if operand == "a":
                a[:, 0], b[:, 0] = words, 1.0
            else:
                a[:, 0], b[:, 0] = 1.0, torch.cat([words] * (n // 64))
            d = run(torch, probe, a, b, mode, n)
            got = d[:, 0] if operand == "a" else d[0, :64]
            out[f"{form}_{operand}"] = [name for name, want in rules.items() if torch.equal(got, want)]
    return out


def run(torch, probe, a, b, mode: int, n: int) -> "torch.Tensor":
    a_d, b_d = a.contiguous().cuda(), b.contiguous().cuda()
    d = torch.empty(64, n, device="cuda")
    rc = probe.gofr_tf32_probe(a_d.data_ptr(), b_d.data_ptr(), d.data_ptr(), mode)
    if rc != 0:
        raise SystemExit(f"the tf32 probe failed to launch: CUDA error {rc}")
    return d.cpu()


def layout_check(torch, probe) -> dict:
    """Random tiles exact in tf32 (multiples of 1/4 in [-4, 4]): the card's
    product against the host's, for each form (max abs difference)."""
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 32)
    out = {}
    for form, (mode, n) in MODES.items():
        a = torch.randint(-16, 17, (64, 8), generator=gen).float() / 4
        b = torch.randint(-16, 17, (n, 8), generator=gen).float() / 4
        out[form] = (run(torch, probe, a, b, mode, n) - a.double().matmul(b.double().T).float()
                     ).abs().max().item()
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "STL", "LDL",
            "BAR.SYNC", "SYNCS")


def sass_counts(library: Path, fragment: str) -> dict:
    """Per function whose name holds ``fragment``: how many SASS lines name
    each of ``SASS_OPS``, and each distinct WARPGROUP.DEPBAR form."""
    tool = Path(cuda.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if fragment not in name:
            continue
        codes = [opcode(ln) for ln in block.splitlines() if "*/" in ln]
        row = {op: sum(c == op or c.startswith(op + ".") for c in codes) for op in SASS_OPS}
        row["depbar_forms"] = sorted(set(re.findall(r"WARPGROUP\.DEPBAR[^;]*", block)))
        out[name] = row
    return out


def opcode(line: str) -> str:
    """A SASS line's opcode (after its address and any predicate), or ""."""
    tokens = line.split("*/", 1)[1].split()
    if tokens and tokens[0].startswith("@"):
        tokens = tokens[1:]
    return tokens[0] if tokens and not tokens[0].startswith("/*") else ""


def reference_f64(torch, q, k, v, causal: bool) -> "torch.Tensor":
    """The attention of f32 q, k, v in f64 throughout (scores, softmax, P.V),
    GQA by h / group, no offsets or lengths."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    qh = q.double().transpose(1, 2)
    kh, vh = (t.double().transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    scores = qh @ kh.transpose(-1, -2) * d ** -0.5
    if causal:
        scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1),
                                    float("-inf"))
    return (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2)


def error_study(torch) -> dict:
    """The body, the f32 plain version and the tile emulation, each against
    an f64 reference, at two phase-3 shapes."""
    from test_torch_flash_f32_tiles import flash_f32_tiles

    from gofr_tpu_torch.ops.attention import mha_attention_plain
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 33)
    shapes = {"4x512_causal_d128": ((4, 512, 32, 8, 128), dict(causal=True)),
              "vit_32x197_d64": ((32, 197, 16, 16, 64), dict(causal=False))}
    out = {}
    for label, ((b, s, hq, hkv, d), kw) in shapes.items():
        q = torch.randn(b, s, hq, d, device="cuda", generator=gen)
        k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen) for _ in range(2))
        exact = reference_f64(torch, q, k, v, kw["causal"])
        row = {}
        for name, got in (("kernel", flash_attention(q, k, v, **kw)),
                          ("plain_f32", mha_attention_plain(q, k, v, **kw)),
                          ("emulation", flash_f32_tiles(q, k, v, **kw))):
            diff = got.double() - exact
            row[name] = {"max_abs": diff.abs().max().item(),
                         "rms_rel": (diff.pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()).item()}
        kernel = flash_attention(q, k, v, **kw).double()
        row["kernel_vs_emulation_max_abs"] = (kernel - flash_f32_tiles(q, k, v, **kw).double()
                                              ).abs().max().item()
        row["kernel_vs_plain_max_abs"] = (kernel - mha_attention_plain(q, k, v, **kw).double()
                                          ).abs().max().item()
        out[label] = row
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_f32_probe: no CUDA device available")
    os.chdir(REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"nvidia_smi": chip_smoke.smi_line()}
    probe = build_probe()
    result["layout_max_abs"] = layout_check(torch, probe)
    result["read_rule"] = read_rule(torch, probe)
    print(json.dumps({k: result[k] for k in ("layout_max_abs", "read_rule")}), flush=True)
    built = cuda.build()
    cuda.load(built["library"])
    result["ptxas"] = chip_smoke.ptxas_usage(built["ptxas"], "flash_kernel_f32")
    result["sass"] = sass_counts(built["library"], "flash_kernel_f32")
    print(json.dumps({k: result[k] for k in ("ptxas", "sass")}), flush=True)
    result["errors_vs_f64"] = error_study(torch)
    print(json.dumps(result["errors_vs_f64"]), flush=True)
    print(result["nvidia_smi"])
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_f32_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    bad = [form for form, err in result["layout_max_abs"].items() if err != 0]
    unread = [key for key, rules in result["read_rule"].items() if not rules]
    if bad or unread:
        raise SystemExit(f"layout products off: {bad}; words read by no rule: {unread}")


if __name__ == "__main__":
    main()
