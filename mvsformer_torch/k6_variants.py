"""Time K6 `gsa_attention` against probes and design alternatives on one GPU.

    python -m mvsformer_torch.k6_variants [--reps 20] [--rounds 3] [--parent DIR]

Each variant is `csrc/gsa_attention.cu` with a few lines substituted,
built with the kernels' own nvcc flags (`mvsformer_torch.kernel_variants`),
and timed by CUDA events, the kernel alone (its C function called directly,
no wrapper), at the 9 launch shapes of the DTU eval request: B = 5 views,
Nk = 432 keys, (N, C) = (27648, 64), (6912, 128), (1728, 256) five times
and (432, 512) twice, heads 32 wide, k and v the two halves of one
[B, Nk, 2C] tensor as the model's kv projection gives them; q and kv
standard normal from seed 0. The variants run in turns over several rounds.
Probes compute wrong numbers on purpose; every other variant is held to
`gsa_attention_plain` within 1e-5 of max(1, max |output|) at every shape.

Variants of the design as built (`VARIANTS`; one warp per 16 rows, 4
warps a block, 64-key tiles, K, V and P split by truncation where read,
probabilities by ex2.approx.ftz): 32-key tiles (with 4 or 5 blocks an SM),
32 rows a warp (MT = 2, with 64- or 32-key tiles), 8 warps a block, the
split by cvt.rna, operands handed to the mma unmasked (the same products
if the tensor cores ignore an operand's 13 low bits), exp2f; and the
probes 1xTF32 (one mma per step instead of three), no exponential, no PV
product, and the K and V copies alone (no products).

With `--parent DIR` (a checkout of the tree before K6 ran on the tensor
cores, e.g. `git archive d172a9d | tar -x -C scratch_chip/p9`) it also
builds that tree's FFMA kernel (one thread per query row, 128 rows a block,
K and V through shared memory in chunks of 64 keys, scores of 32 keys at a
time in registers) and its probes (`PARENT_VARIANTS`): no exponential (a
subtraction in its place), no PV product, SUB = 16 (16 scores a batch) and
256-row blocks.

With `--rounds 0` it builds and checks every variant and times none.
Prints the card, then one JSON line per variant: ptxas registers, spills
and static shared memory, resident blocks per SM where the source reports
them, the error against the plain version, ms per launch shape (the least
of the rounds), ms per request (the shapes times their launches), and its
share of the request's 0.278 ms tensor-core bound (3xTF32: 3 x 2 x
22.9 G multiply-adds over 494.7 TFLOP/s). Then one line with
scaled_dot_product_attention's ms per shape on the same inputs, the
library yardstick.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from mvsformer_torch.kernel_variants import build_all, card, ptxas_summary, time_ms
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.gsa_attention import HEAD_DIM, gsa_attention_plain

B, NK = 5, 432
# (N, C, launches per request) of the 9 GSA blocks of alt_gvt_small.
SHAPES = ((27648, 64, 1), (6912, 128, 1), (1728, 256, 5), (432, 512, 2))
TF32_FLOPS_PER_S = 494.7e12


def tensor_bound_ms(n, c):
    """3xTF32: three TF32 products per multiply-add, 2 b n nk c of them."""
    return 3 * 2 * 2 * B * n * NK * c / TF32_FLOPS_PER_S * 1e3


# The design as built (csrc/gsa_attention.cu): one warp per 16 rows, 4 warps
# a block, K and V tiles of KT = 64 keys double buffered by cp.async, K, V
# and P split by truncation where read, both products 3xTF32 on mma.sync,
# probabilities by ex2.approx.ftz.
_KT = "constexpr int KT = 64;"
_MT = "constexpr int MT = 1;"
_WARPS = "constexpr int kWarps = 4;"
_MIN_BLOCKS = "constexpr int kMinBlocks = 4;"
_TRUNC = "  return __float_as_uint(x) & 0xffffe000u;\n"
_SPLIT_B = ("  return make_float4(__uint_as_float(h0), __uint_as_float(h1),\n"
            "                     __uint_as_float(tf32_trunc(__fsub_rn(b0, __uint_as_float(h0)))),\n"
            "                     __uint_as_float(tf32_trunc(__fsub_rn(b1, __uint_as_float(h1)))));\n")
_SPLIT_P = ("    ah[i] = tf32_trunc(a[i]);\n"
            "    al[i] = tf32_trunc(__fsub_rn(a[i], __uint_as_float(ah[i])));\n")
_MMA_S = "            mma_3xtf32(part, qh[m][ch], ql[m][ch], bk);\n"
_MMA_O = "            mma_3xtf32(part, ph[m], pl[m], bv);\n"
_EXP_P = "              s[m][j][e] = exp2_ftz(fmaf(s[m][j][e], c, -mnew));\n"
_EXP_CORR = "          const float corr = exp2f(mx[m][h] - mnew);  // 0 on the first tile (mx = -inf)\n"
_MMA1_FN = ("__device__ __forceinline__ void mma_1xtf32(float* d, const uint32_t* ah, "
            "const uint32_t* al, float4 b) {\n  mma_tf32(d, ah, b.x, b.y);\n}\n\n")
_CP_ASYNC = "__device__ __forceinline__ void cp_async16("

VARIANTS = {
    "as built": [],
    "KT=32": [(_KT, "constexpr int KT = 32;")],
    "KT=32, 5 blocks an SM": [(_KT, "constexpr int KT = 32;"),
                              (_MIN_BLOCKS, "constexpr int kMinBlocks = 5;")],
    "MT=2, KT=32, 3 blocks an SM": [(_MT, "constexpr int MT = 2;"), (_KT, "constexpr int KT = 32;"),
                                    (_MIN_BLOCKS, "constexpr int kMinBlocks = 3;")],
    "MT=2 (32 rows a warp), 2 blocks an SM": [(_MT, "constexpr int MT = 2;"),
                                              (_MIN_BLOCKS, "constexpr int kMinBlocks = 2;")],
    "8 warps a block, 2 blocks an SM": [(_WARPS, "constexpr int kWarps = 8;"),
                                        (_MIN_BLOCKS, "constexpr int kMinBlocks = 2;")],
    "split by cvt.rna": [(_TRUNC, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
                                  '"f"(x));\n  return r;\n')],
    # hi passed unmasked and lo = x - hi unmasked: the same products if the
    # tensor cores ignore an operand's 13 low bits.
    "operands unmasked (the mma truncates)": [
        (_SPLIT_B, "  return make_float4(b0, b1, __fsub_rn(b0, __uint_as_float(h0)),\n"
                   "                     __fsub_rn(b1, __uint_as_float(h1)));\n"),
        (_SPLIT_P, "    ah[i] = __float_as_uint(a[i]);\n"
                   "    al[i] = __float_as_uint(__fsub_rn(a[i], __uint_as_float(tf32_trunc(a[i]))));\n")],
    "exp2f": [(_EXP_P, _EXP_P.replace("exp2_ftz", "exp2f"))],
    "probe: 1xTF32": [(_CP_ASYNC, _MMA1_FN + _CP_ASYNC),
                      (_MMA_S, _MMA_S.replace("mma_3xtf32", "mma_1xtf32")),
                      (_MMA_O, _MMA_O.replace("mma_3xtf32", "mma_1xtf32"))],
    "probe: no exponential": [(_EXP_P, "              s[m][j][e] = fmaf(s[m][j][e], c, -mnew);\n"),
                              (_EXP_CORR, "          const float corr = mx[m][h] < mnew ? 0.5f : 1.0f;\n")],
    "probe: no PV product": [(_MMA_O, "            (void)bv;\n")],
    "probe: copies only": [("    if (busy) {\n      const float* kt", "    if (N < 0) {\n      const float* kt")],
}

# The FFMA kernel of the parent tree and its probes.
_PARENT_CORR = "      const float corr = expf(m - mnew);  // 0 on the first batch (m = -inf)\n"
_PARENT_P = "          const float p = expf(s[j] - mnew);\n"
_PARENT_PV = ("            const float4 vv = *reinterpret_cast<const float4*>(&vs[s0 + j][d]);\n"
       "            o[d] += p * vv.x; o[d + 1] += p * vv.y; o[d + 2] += p * vv.z; "
       "o[d + 3] += p * vv.w;\n")
PARENT_VARIANTS = {
    "as built": [],
    "probe: no exponential": [(_PARENT_CORR, "      const float corr = m < mnew ? 0.5f : 1.0f;\n"),
                              (_PARENT_P, "          const float p = s[j] - mnew;\n")],
    "probe: no PV product": [(_PARENT_PV, "            (void)d;\n")],
    "probe: SUB=16": [("constexpr int SUB = 32;", "constexpr int SUB = 16;")],
    "256-row blocks": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
}


def launch(lib, q, kv, nh, out, stream):
    """One launch of a built library's gsa_attention_f32 (k and v the two
    halves of kv)."""
    b, n, c = q.shape
    k, v = kv[..., :c], kv[..., c:]
    rc = lib.gsa_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               b, n, k.shape[1], nh, q.stride(0), q.stride(1), k.stride(0),
                               k.stride(1), v.stride(0), v.stride(1),
                               ctypes.c_float(HEAD_DIM ** -0.5), stream)
    cuda_build.check_launch(rc, "gsa_attention")


def sdpa_ms(q, kv, nh, reps):
    import torch.nn.functional as F

    b, n, c = q.shape
    heads = lambda t: t.reshape(b, t.shape[1], nh, c // nh).transpose(1, 2)
    qh, kh, vh = heads(q), heads(kv[..., :c]), heads(kv[..., c:])
    return time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the tree with the FFMA kernel, to time it and its probes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card()
    print(f"card: {name_limit}", flush=True)
    sets = {"": (VARIANTS, cuda_build.CSRC)}
    if args.parent is not None:
        sets["parent: "] = (PARENT_VARIANTS, args.parent / "mvsformer_torch" / "csrc")
    built = {}
    for prefix, (variants, csrc) in sets.items():
        for name, entry in build_all("gsa_attention", variants, csrc).items():
            built[prefix + name] = entry
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for n, c, count in SHAPES:
        q = torch.from_numpy(rng.standard_normal((B, n, c)).astype(np.float32)).cuda()
        kv = torch.from_numpy(rng.standard_normal((B, NK, 2 * c)).astype(np.float32)).cuda()
        nh = c // HEAD_DIM
        cases.append((f"N={n} C={c}", q, kv, nh, count, torch.empty_like(q)))
    errs = {}
    for name, (lib, _) in list(built.items()):
        errs[name] = 0.0
        for _, q, kv, nh, _, out in cases:
            launch(lib, q, kv, nh, out, stream)
            c = q.shape[2]
            want = gsa_attention_plain(q, kv[..., :c], kv[..., c:], nh)
            errs[name] = max(errs[name], float((out - want).abs().max())
                             / max(1.0, float(want.abs().max())))
        if errs[name] > 1e-5 and "probe" not in name:
            print(f"{name!r} disagrees with the plain version by {errs[name]:.3e} of scale; "
                  "left out", flush=True)
            del built[name]
    names = list(built)
    times = {name: {case[0]: [] for case in cases} for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:  # in turns
            lib = built[name][0]
            for label, q, kv, nh, _, out in cases:
                times[name][label].append(time_ms(
                    lambda: launch(lib, q, kv, nh, out, stream), args.reps))
    bound = sum(tensor_bound_ms(n, c) * count for n, c, count in SHAPES)
    for name in names:  # with --rounds 0: built and checked, not timed
        lib, report = built[name]
        ms = {label: min(t) for label, t in times[name].items() if t}
        per_request = sum(ms[case[0]] * case[4] for case in cases) if ms else float("nan")
        blocks = (lib.gsa_attention_blocks_per_sm()
                  if hasattr(lib, "gsa_attention_blocks_per_sm") else None)
        print(json.dumps({
            "variant": name, "ptxas": ptxas_summary(report), "blocks_per_sm": blocks,
            "max_err_of_scale": errs[name],
            "ms": {label: round(t, 4) for label, t in ms.items()},
            "ms_all_rounds": {label: [round(x, 4) for x in t]
                              for label, t in times[name].items()},
            "ms_per_request": round(per_request, 4),
            "share_of_tensor_bound": round(bound / per_request, 4), "card": name_limit}),
            flush=True)
    if args.rounds:
        lib_ms = {label: round(sdpa_ms(q, kv, nh, args.reps), 4)
                  for label, q, kv, nh, _, _ in cases}
        print(json.dumps({
            "library": "scaled_dot_product_attention", "ms": lib_ms,
            "ms_per_request": round(sum(lib_ms[case[0]] * case[4] for case in cases), 4),
            "tensor_bound_ms": {f"N={n} C={c}": round(tensor_bound_ms(n, c), 4)
                                for n, c, _ in SHAPES},
            "card": name_limit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
