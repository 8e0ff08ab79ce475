"""K1 (``csrc/pose_opt.cu``, fused motion-only BA): the least time the
card could take for a launch (the larger of its FLOP over 67 TFLOP/s and
its bytes over 3.35 TB/s, the H100 SXM's float32 and HBM3 peaks) over
its device time, in %, a launch's mean over the traced stretch.

FLOP and bytes are counted from each launch's arguments as PERF.md's
kernel table counts them (from ``csrc/pose_opt.cu``): a Gauss-Newton
pass is 180 FLOP an edge, an acceptance pass 56, a 6x6 solve and
retract ~400 once a pass; each input byte read once, each output byte
written once.
"""

from benchmark.harness import trace

PEAK_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
ROUNDS, ITERS = 4, 10
FLOP_GN_EDGE, FLOP_CHI2_EDGE, FLOP_SOLVE = 180, 56, 400
BYTES_EDGE = 12 + 12 + 4 + 1 + 1 + 1


def flops_bytes(args):
    """(FLOP, bytes) of one launch with the entry's arguments (cam,
    pose0, pw, obs_uvr, level, has_stereo, valid, w_table, ...)."""
    pose0, pw, valid = args[1], args[2], args[6]
    P, E = pose0.numel() // 7, pw.shape[-2]
    n_valid = int(valid.sum())
    flops = n_valid * (ROUNDS * ITERS * FLOP_GN_EDGE
                       + ROUNDS * FLOP_CHI2_EDGE) \
        + P * ROUNDS * (ITERS + 1) * FLOP_SOLVE
    return flops, P * (E * BYTES_EDGE + 4 * (7 + 32 + 8 + 1))


def bound_s(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def read(run):
    p = run.profile
    if not p or not p.get("k1_args"):
        return None
    us = trace.kernel_us(p, "pose_opt_kernel")
    if not us or not sum(us):
        return None
    # per launch on both sides: the trace and the wrapper count the same
    # launches, but a mean does not need them paired
    least = sum(bound_s(*flops_bytes(a)) for a in p["k1_args"]) \
        / len(p["k1_args"])
    return 100.0 * least / (sum(us) / len(us) / 1e6)
