#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s kernel check catch a wrong kernel? (one card)

    python3 scripts/torch_kernel_mutants.py

Each mutant is a copy of ``gofr_tpu_torch/csrc`` with one planted fault (a
length mask off by one, a live page skipped, a key left out of P.V, ...),
made and built under ``gofr_tpu_torch/build/mutants/`` at run time; the
sources in the checkout are never changed. Every mutant library is loaded
in turn and put through ``chip_smoke.check_kernels`` (the same inputs and
per-kernel limits, untimed), every kernel checked even after one fails, so
a fault in code that two kernels share shows in both. The unmodified
sources go first and must pass. Then the builds named in ``PHASE5`` are
read through ``chip_smoke.model_check`` (a full-width Llama-3-8B with
random weights from the seed, end to end, kernels against plain) on the
pools named there; these readings are reported, not judged.

Prints one JSON line per build, then a summary, and writes them all to
``chiprun_out/kernel_mutants.json``. Exits non-zero if the unmodified build
fails or a mutant marked ``must_catch`` passes. A mutant not so marked
records what the check cannot resolve.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig, init  # noqa: E402
from gofr_tpu_torch.ops import cuda  # noqa: E402

# (name, file, text to replace, replacement, must_catch)
MUTANTS = [
    ("paged_decode: one key past the length", "paged_decode.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] + 1, 0), maxp * page)", True),
    ("paged_decode: last live key dropped", "paged_decode.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] - 1, 0), maxp * page)", True),
    ("paged_decode: first live page skipped", "paged_decode.cu",
     "for (int t0 = 0; t0 < len; t0 += kTile)", "for (int t0 = page; t0 < len; t0 += kTile)", True),
    ("paged_decode: last key of each tile left out of P.V", "paged_decode.cu",
     "for (int t = 0; t < kTile; ++t) {", "for (int t = 0; t < kTile - 1; ++t) {", True),
    ("kv_append: row one past the position", "kv_append.cu",
     "const int off = pos % page;", "const int off = (pos + 1) % page;", True),
    ("flash_attention: causal diagonal masked", "flash_attention.cu",
     "qo + q0 + r >= kv", "qo + q0 + r > kv", True),
    ("flash_attention: one key past kv_length", "flash_attention.cu",
     "const bool ok = kv < kl &&", "const bool ok = kv <= kl &&", True),
    ("flash_attention: last key tile skipped", "flash_attention.cu",
     "for (int k0 = 0; k0 < kv_end; k0 += kBK)", "for (int k0 = 0; k0 < kv_end - kBK; k0 += kBK)", True),
    ("paged_decode_q/_q4: ks fold dropped", "paged_decode_q.cu",
     "s * scale * ks_s[t]", "s * scale", True),
    ("paged_decode_q/_q4: vs fold dropped", "online_softmax.cuh",
     "row[lane] = p.x * vs[lane];\n  row[lane + 32] = p.y * vs[lane + 32];",
     "row[lane] = p.x;\n  row[lane + 32] = p.y;", True),
    ("paged_decode_q/_q4: one key past the length", "paged_decode_q.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] + 1, 0), maxp * page)", True),
    ("paged_decode_q4: nibble halves swapped", "paged_decode_q.cu",
     "kLoShift = 0, kHiShift = 4", "kLoShift = 4, kHiShift = 0", True),
    ("paged_decode_q4: bias of 7 instead of 8", "paged_decode_q.cu",
     "kBias = 8", "kBias = 7", True),
    # p kept in f32 instead of rounded to bf16 before P.V: a relative change
    # of at most 2^-9 on each probability, averaged over hundreds of keys,
    # is below a bf16 ulp of the outputs, so no output check can see it
    ("online_softmax: p not rounded to bf16", "online_softmax.cuh",
     "row[lane] = round_bf16(pa);\n  row[lane + 32] = round_bf16(pb);",
     "row[lane] = pa;\n  row[lane + 32] = pb;", False),
]

# Builds also read through chip_smoke's phase 5 (the model end to end), on
# the pools named: the unmodified build, the nearest fault of each decode
# kernel and a fault of the prefill kernel, to see which faults phase 5
# resolves beside a clean reading.
PHASE5 = {"unmodified": ("", "int8", "int4"),
          "paged_decode: one key past the length": ("",),
          "paged_decode_q/_q4: one key past the length": ("int8", "int4"),
          "flash_attention: causal diagonal masked": ("int4",)}


def make(index: int, mutant) -> dict:
    name, fname, old, new, _ = mutant
    root = cuda.BUILD / "mutants" / f"m{index}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda.CSRC, root / "csrc")
    path = root / "csrc" / fname
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"mutant {name!r}: the text to replace occurs {text.count(old)} times in {fname}")
    path.write_text(text.replace(old, new))
    return cuda.build(root / "csrc", root / "build")


def verdict(torch, library: Path) -> dict:
    """Every kernel's check on one library: passed only if all pass; each
    kernel's verdict, error numbers and failure."""
    cuda.load(library)
    kernels = chip_smoke.check_kernels(torch, timed=False, keep_going=True)
    return {"passed": all(k["passed"] for k in kernels),
            "kernels": {k["name"]: {m: k[m] for m in ("passed", "max_abs_err", "rms_rel_err",
                                                     "failure") if m in k}
                        for k in kernels}}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_mutants: no CUDA device available")
    os.chdir(REPO)
    plan = [("unmodified", None, None, None, False), *MUTANTS]
    with ThreadPoolExecutor(max_workers=4) as pool:
        clean = pool.submit(cuda.build)
        builds = [clean, *(pool.submit(make, i, m) for i, m in enumerate(MUTANTS))]
        libraries = [b.result()["library"] for b in builds]
    results, bad = [], []
    for (name, fname, _, _, must_catch), library in zip(plan, libraries):
        row = {"mutant": name, "file": fname, "must_catch": must_catch, **verdict(torch, library)}
        print(json.dumps(row), flush=True)
        results.append(row)
        if (fname is None and not row["passed"]) or (must_catch and row["passed"]):
            bad.append(name)
    torch.cuda.empty_cache()
    model = init(LlamaConfig.llama3_8b(), torch.Generator(device="cuda").manual_seed(chip_smoke.SEED),
                 "cuda")
    for row, library in zip(results, libraries):
        if row["mutant"] in PHASE5:
            cuda.load(library)
            row["phase5"] = {kvq or "bf16": chip_smoke.model_check(torch, model, kvq, enforce=False)
                             for kvq in PHASE5[row["mutant"]]}
            print(json.dumps({"mutant": row["mutant"], "phase5": row["phase5"]}), flush=True)
    summary = {"caught": sum(not r["passed"] for r in results[1:]), "mutants": len(MUTANTS),
               "unexpected": bad, "nvidia_smi": chip_smoke.smi_line()}
    print(json.dumps(summary))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_mutants.json"), "w") as f:
        json.dump({"results": results, "summary": summary}, f, indent=1)
    if bad:
        raise SystemExit(f"unexpected verdicts: {bad}")


if __name__ == "__main__":
    main()
