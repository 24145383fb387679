#!/usr/bin/env python3
"""Where does a tile's time go in kernel C's f32 body? (one card)

    python3 scripts/torch_flash_f32_trace.py

Builds a copy of ``gofr_tpu_torch/csrc`` (under ``gofr_tpu_torch/build/
trace/``; the sources in the checkout are never changed) in which
``flash_attention_f32.cu`` reads ``clock64`` around each of its waits and
around the producer's two pieces of work, and sums each interval over a
call's blocks into a device array (thread 0 of each warpgroup). Runs the
build once at chip_smoke.py's phase-3 shapes (4 x 1024 and 4 x 512 causal
at D 128, ViT-L/16's 32 x 197 at D 64) and prints, per shape, the cycles a
64-key tile spends in each: the producer's waits (``s_done``, ``k_full``,
``pv_done``, ``v_full``, the named barrier), its K split and V transpose,
and the consumers' waits (``k_full``, ``klo_ready``, the wgmma waits after
S and after P.V, ``vt_ready``) and softmax (with P's split and O's
rescale), beside each warpgroup's whole time. The wgmma issue itself is
what the consumers' whole time leaves. Writes them to
``chiprun_out/flash_f32_trace.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gofr_tpu_torch.ops import cuda  # noqa: E402

SHAPES = {"4x1024_causal_d128": (4, 1024, 32, 8, 128, True),
          "4x512_causal_d128": (4, 512, 32, 8, 128, True),
          "vit_32x197_d64": (32, 197, 16, 16, 64, False)}
PRODUCER = ["wait s_done", "wait k_full", "wait pv_done", "wait v_full", "named barrier", "split_k",
            "transpose_v"]
CONSUMER = ["wait k_full", "wait klo_ready", "S wgmma wait", "wait vt_ready", "P.V wgmma wait",
            "softmax"]
# the statements timed (producer, then consumer), as they stand in the source
P_TIMED = ["gofr::mbar_wait(s_done, (i - 1) & 1);", "gofr::mbar_wait(&k_full[st], (i >> 1) & 1);",
           "if (i > 0) gofr::mbar_wait(pv_done, (i - 1) & 1);", "gofr::mbar_wait(v_full, i & 1);",
           "gofr::named_barrier(1, kConsumers);",
           "split_k<kD>(base + L::kK + st * L::kPlane, base + L::kKlo, p);",
           "transpose_v<kD>(base + L::kV, base + L::kVtHi, base + L::kVtLo, p);"]
C_TIMED = ["gofr::mbar_wait(&k_full[i & 1], (i >> 1) & 1);", "gofr::mbar_wait(klo_ready, i & 1);",
           "gofr::wgmma_wait<0>();\n    gofr::fence_regs(s);", "gofr::mbar_wait(vt_ready, i & 1);",
           "gofr::wgmma_wait<0>();\n    gofr::fence_regs(o);"]


def instrumented(text: str) -> str:
    """flash_attention_f32.cu with the intervals summed into g_trace."""
    def sub(old: str, new: str) -> None:
        nonlocal text
        if text.count(old) != 1:
            raise SystemExit(f"the text to instrument occurs {text.count(old)} times: {old!r}")
        text = text.replace(old, new)

    sub('#include "online_softmax.cuh"\n', '''#include "online_softmax.cuh"
__device__ unsigned long long g_trace[32];
extern "C" int gofr_trace_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
extern "C" int gofr_trace_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
#define TW(acc, call) do { const long long t0_ = clock64(); call; acc += (unsigned)(clock64() - t0_); } while (0)
''')
    for k, s in enumerate(P_TIMED):
        sub(s, f"TW(pacc[{k}], {s.rstrip(';')});")
    for k, s in enumerate(C_TIMED):
        first, *rest = s.split("\n")
        sub(s, "\n".join([f"TW(cacc[{k}], {first.strip().rstrip(';')});", *rest]))
    sub("    const int p = tid - kConsumers, hk = h / group;\n",
        "    const int p = tid - kConsumers, hk = h / group;\n"
        "    unsigned pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n    const long long pt0 = clock64();\n")
    sub("      }\n    }\n    return;\n  }\n\n  // the consumer warpgroup\n",
        "      }\n    }\n    if (p == 0) {\n"
        "      for (int k = 0; k < 7; ++k) atomicAdd(&g_trace[k], (unsigned long long)pacc[k]);\n"
        "      atomicAdd(&g_trace[7], (unsigned long long)(clock64() - pt0));\n"
        "      atomicAdd(&g_trace[8], (unsigned long long)n_tiles);\n    }\n    return;\n  }\n\n"
        "  // the consumer warpgroup\n")
    sub("  gofr::setmaxnreg_inc<kConsumerRegs>();\n",
        "  gofr::setmaxnreg_inc<kConsumerRegs>();\n  unsigned cacc[6] = {0, 0, 0, 0, 0, 0};\n"
        "  const long long ct0 = clock64();\n")
    sub("    // scale (into base 2)", "    const long long sm0 = clock64();\n    // scale (into base 2)")
    sub("    TW(cacc[3], gofr::mbar_wait(vt_ready",
        "    cacc[5] += (unsigned)(clock64() - sm0);\n    TW(cacc[3], gofr::mbar_wait(vt_ready")
    sub("  const float l_lo = gofr::quad_sum(st[0].l), l_hi = gofr::quad_sum(st[1].l);\n",
        "  if (tid == 0) {\n"
        "    for (int k = 0; k < 6; ++k) atomicAdd(&g_trace[16 + k], (unsigned long long)cacc[k]);\n"
        "    atomicAdd(&g_trace[22], (unsigned long long)(clock64() - ct0));\n"
        "    atomicAdd(&g_trace[23], 1ull);\n  }\n"
        "  const float l_lo = gofr::quad_sum(st[0].l), l_hi = gofr::quad_sum(st[1].l);\n")
    return text


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_f32_trace: no CUDA device available")
    os.chdir(REPO)
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    root = cuda.BUILD / "trace"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda.CSRC, root / "csrc")
    source = root / "csrc" / "flash_attention_f32.cu"
    source.write_text(instrumented(source.read_text()))
    lib = cuda.load(cuda.build(root / "csrc", root / "build")["library"])
    lib.gofr_trace_read.argtypes = [ctypes.c_void_p]
    lib.gofr_trace_read.restype = ctypes.c_int
    lib.gofr_trace_reset.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    result = {"unit": "clock64 cycles a 64-key tile (summed over the call's blocks, over its tiles)",
              "nvidia_smi": chip_smoke.smi_line()}
    for label, (b, s, hq, hkv, d, causal) in SHAPES.items():
        q = torch.randn(b, s, hq, d, device="cuda", generator=gen)
        k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen) for _ in range(2))
        flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        lib.gofr_trace_reset()
        flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        lib.gofr_trace_read(ctypes.addressof(buf))
        tiles = buf[8]
        row = {f"producer {n}": buf[i] / tiles for i, n in enumerate(PRODUCER)}
        row["producer whole"] = buf[7] / tiles
        row.update({f"consumer {n}": buf[16 + i] / tiles for i, n in enumerate(CONSUMER)})
        row.update({"consumer whole": buf[22] / tiles, "tiles": tiles, "blocks": buf[23]})
        result[label] = row
        print(label, json.dumps(row), flush=True)
    print(result["nvidia_smi"])
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_f32_trace.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
