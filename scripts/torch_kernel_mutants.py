#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s kernel check catch a wrong kernel? (one card)

    python3 scripts/torch_kernel_mutants.py

Each mutant is a copy of ``gofr_tpu_torch/csrc`` with one planted fault (a
length mask off by one, a live tile skipped, a key left out of P.V, ...),
made and built under ``gofr_tpu_torch/build/mutants/`` at run time; the
sources in the checkout are never changed. Every mutant library is loaded
in turn and put through ``chip_smoke.check_kernels`` (the same inputs and
per-kernel limits, untimed), every kernel checked even after one fails, so
a fault in code that two kernels share shows in both. The unmodified
sources go first and must pass. Then the builds named in ``PHASE5`` are
read through ``chip_smoke.model_check`` (a full-width Llama-3-8B with
random weights from the seed, end to end, kernels against plain) on the
caches named there; these readings are reported, not judged. Kernels A,
D and E (the page pool's decodes) are one template in
``paged_decode_q.cu``, so a fault in its shared body lands in all three;
the merge of a split decode (``split_merge.cuh``) is one kernel for F, A,
D and E; the five appends (B, G, B-q, B-q4, G-q) are one template in
``kv_append.cu``, held bit for bit. The W8A16 linear's two tilings and
its split's second pass are one source, ``w8a16.cu``.

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
    # kernels A, D and E are one template in paged_decode_q.cu
    ("paged_decode/_q/_q4: one key past the length", "paged_decode_q.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] + 1, 0), maxp * page)", True),
    ("paged_decode/_q/_q4: last live key dropped", "paged_decode_q.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] - 1, 0), maxp * page)", True),
    # the scores of the sequence's first 64 rows masked: as if never loaded
    ("paged_decode/_q/_q4: first live tile skipped", "paged_decode_q.cu",
     "p_s[quad][t] = (t0 + t < t_end)", "p_s[quad][t] = (t0 >= kTile && t0 + t < t_end)", True),
    # position 16k + 15 of every tile out of the tensor-core P.V (still in l)
    ("paged_decode: last key of every 16 left out of P.V", "paged_decode_q.cu",
     "a[2] = bf16_pair(hi.x, hi.y);", "a[2] = bf16_pair(hi.x, c == 3 ? 0.f : hi.y);", True),
    ("decode_attention: first live tile skipped", "paged_decode.cu",
     "p_s[g][t] = (t0 + t < t_end)", "p_s[g][t] = (t0 >= kTile && t0 + t < t_end)", True),
    ("decode_attention: last key of each tile left out of P.V", "paged_decode.cu",
     "for (int t = 0; t < kTile; ++t) {", "for (int t = 0; t < kTile - 1; ++t) {", True),
    ("decode_attention: one key past the length", "paged_decode.cu",
     "min(max(lengths[n], 0), smax)", "min(max(lengths[n] + 1, 0), smax)", True),
    ("decode_attention: last live key dropped", "paged_decode.cu",
     "min(max(lengths[n], 0), smax)", "min(max(lengths[n] - 1, 0), smax)", True),
    # the lane past the slot reads five rows of the next head
    ("decode_attention: length not clamped to Smax", "paged_decode.cu",
     "min(max(lengths[n], 0), smax)", "max(lengths[n], 0)", True),
    # the five appends are one template in kv_append.cu: B, B-q, B-q4 share
    # PoolAddr, G and G-q SlotAddr, B-q, B-q4 and G-q the quantizer
    ("kv_append/_q/_q4: row one past the position", "kv_append.cu",
     "const int off = pos % page;", "const int off = (pos + 1) % page;", True),
    ("kv_append/_q/_q4: no drop at pos // page == MaxP", "kv_append.cu",
     "if (logical >= maxp) return -1;", "if (logical > maxp) return -1;", True),
    ("kv_append_slot/_slot_q: row one past the position", "kv_append.cu",
     "* smax + pos;", "* smax + pos + 1;", True),
    ("kv_append_slot/_slot_q: no drop at pos == Smax", "kv_append.cu",
     "pos >= smax", "pos > smax", True),
    ("kv_append_q/_q4/_slot_q: round toward zero", "kv_append.cu",
     "__float2int_rn(x[i] / s)", "__float2int_rz(x[i] / s)", True),
    ("kv_append_q/_q4/_slot_q: the scale from one lane's max, not the warp's", "kv_append.cu",
     "for (int o = 16; o > 0; o >>= 1)", "for (int o = 16; o > 16; o >>= 1)", True),
    ("kv_append_q/_q4/_slot_q: K and V scales written to each other's plane", "kv_append.cu",
     "bf16* scales = is_v ? p.vs : p.ks;", "bf16* scales = is_v ? p.ks : p.vs;", True),
    ("kv_append_q4: nibble halves swapped", "kv_append.cu",
     "static_cast<uint32_t>(lo + kBias) | (static_cast<uint32_t>(hi + kBias) << 4)",
     "static_cast<uint32_t>(hi + kBias) | (static_cast<uint32_t>(lo + kBias) << 4)", True),
    ("kv_append_q4: bias of 7 instead of 8", "kv_append.cu",
     "constexpr int kBias = 8;", "constexpr int kBias = 7;", True),
    ("flash_attention: causal diagonal masked", "flash_attention.cu",
     "(!causal || pos >= kv)", "(!causal || pos > kv)", True),
    ("flash_attention: one key past kv_length", "flash_attention.cu",
     "!(kv < kl &&", "!(kv <= kl &&", True),
    ("flash_attention: last key tile skipped", "flash_attention.cu",
     "n_tiles = (kv_end + kBK - 1) / kBK;", "n_tiles = (kv_end - 1) / kBK;", True),
    ("flash_attention: online rescale of O skipped", "flash_attention.cu",
     "o[j][0] *= alpha[0], o[j][1] *= alpha[0], o[j][2] *= alpha[1], o[j][3] *= alpha[1];",
     "(void)alpha;", True),
    # keys 8..15 of every 16-key step left out of P.V (for half the columns)
    ("flash_attention: second k16-half of a fragment dropped from P.V", "flash_attention.cu",
     "mma_bf16(o[2 * dp], pf[kk], vf[j][0], vf[j][1]);", "mma_bf16(o[2 * dp], pf[kk], vf[j][0], 0u);", True),
    # the merge is one kernel for F, A, D and E
    ("decode_attention/paged_decode/_q/_q4: last live split left out of the merge", "split_merge.cuh",
     "for (int s = 0; s < live; ++s) {", "for (int s = 0; s < live - 1; ++s) {", True),
    ("decode_attention/paged_decode/_q/_q4: a split's max ignored in the merge (no rescale)",
     "split_merge.cuh",
     "const float w = expf(st[s * kState + kD] - safe);", "const float w = 1.f;", True),
    ("decode_attention: split boundaries overlapping by one row", "paged_decode.cu",
     "min(len, t_begin + split_rows);", "min(len, t_begin + split_rows + 1);", True),
    ("paged_decode_q/_q4: ks fold dropped", "paged_decode_q.cu",
     "x *= __bfloat162float(ks_tile[t]);", "x *= 1.f;", True),
    # each score scaled by the next row's K scale (the last row's by the first's)
    ("paged_decode_q/_q4: K scales one row off", "paged_decode_q.cu",
     "ks_tile[t]", "ks_tile[(t + 1) % kTile]", True),
    ("paged_decode_q/_q4: vs fold dropped", "online_softmax.cuh",
     "row[lane] = p.x * vs[lane];\n  row[lane + 32] = p.y * vs[lane + 32];",
     "row[lane] = p.x;\n  row[lane + 32] = p.y;", True),
    ("paged_decode/_q/_q4: split boundaries overlapping by one row", "paged_decode_q.cu",
     "min(len, t_begin + split_rows);", "min(len, t_begin + split_rows + 1);", True),
    # rows addressed through the entries staged for the tile before (the
    # right page only where both tiles lie in one page)
    ("paged_decode/_q/_q4: a tile read through the previous tile's table entries",
     "paged_decode_q.cu", "const int* entry = entries_s[i % kEntryBufs];",
     "const int* entry = entries_s[(i + kEntryBufs - 1) % kEntryBufs];", True),
    ("paged_decode_q4: nibble halves swapped", "paged_decode_q.cu",
     "kLoShift = 0, kHiShift = 4", "kLoShift = 4, kHiShift = 0", True),
    ("paged_decode_q4: bias of 7 instead of 8", "paged_decode_q.cu",
     "kBias = 8", "kBias = 7", True),
    # the W8A16 linear: the stream (M <= 64, split over K or not), the
    # split's second pass and the tiles (M > 64) are one source
    ("w8a16: the next channel's scale after a split", "w8a16.cu",
     "scaled(acc, s[i % n])", "scaled(acc, s[(i + 1) % n])", True),
    ("w8a16: the last chunk of K dropped (stream)", "w8a16.cu",
     "const int c_end = min(chunks, c_begin + per_split);",
     "const int c_end = min(chunks - 1, c_begin + per_split);", True),
    ("w8a16: the last k tile dropped (tiles)", "w8a16.cu",
     "const int tiles = (k + kBK - 1) / kBK;", "const int tiles = (k - 1) / kBK;", True),
    ("w8a16: the first split's partial summed twice", "w8a16.cu",
     "float acc = 0.f;", "float acc = partial[i];", True),
    # y = bf16(acc * bf16(s)): one rounding instead of two, an ulp off where
    # bf16(acc) rounds away
    ("w8a16: the sum's rounding to bf16 skipped", "w8a16.cu",
     "return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) *",
     "return __float2bfloat16(acc *", True),
    ("w8a16: every fourth weight one code off (the int8 bias)", "w8a16.cu",
     "__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f",
     "__byte_perm(u, 0x4B000000u, 0x7650)) - 8388735.f", True),
    ("w8a16: the X pairs of a step swapped (stream)", "w8a16.cu",
     "mma_bf16(acc[mt], frag[t], xw[2 * t], xw[2 * t + 1]);",
     "mma_bf16(acc[mt], frag[t], xw[2 * t + 1], xw[2 * t]);", True),
    ("w8a16: a B fragment's upper k pair read from the lower (tiles)", "w8a16.cu",
     "*reinterpret_cast<const uint16_t*>(qr + 8)", "*reinterpret_cast<const uint16_t*>(qr)", True),
    # p kept in f32 instead of rounded to bf16 before P.V (A packs it for
    # the tensor cores by truncation, F multiplies it in f32): a relative
    # change of at most 2^-8 on each probability, averaged over hundreds of
    # keys, is below a bf16 ulp of the outputs, so no output check can see it
    ("online_softmax: p not rounded to bf16", "online_softmax.cuh",
     "row[lane] = round_bf16(pa);\n  row[lane + 32] = round_bf16(pb);",
     "row[lane] = pa;\n  row[lane + 32] = pb;", False),
]

# Builds also read through chip_smoke's phase 5 (the model end to end), on
# the caches named, (kv_layout, kv_quantize): the unmodified build, the
# nearest fault of each decode kernel and a fault of the prefill kernel, to
# see which faults phase 5 resolves beside a clean reading.
PHASE5 = {"unmodified": chip_smoke.RUNS,
          "paged_decode/_q/_q4: one key past the length": (("paged", ""), ("paged", "int8"),
                                                           ("paged", "int4")),
          "flash_attention: causal diagonal masked": (("paged", "int4"),),
          "decode_attention: one key past the length": (("slot", ""),)}


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
            row["phase5"] = {chip_smoke.run_name(*run): chip_smoke.model_check(
                torch, model, run[1], enforce=False, kv_layout=run[0]) for run in PHASE5[row["mutant"]]}
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
