"""The agreement of two evaluation reports of `cli/eval_checkpoint.py`:
the bounds derived in tests/test_torch_quality.py's docstring, which holds
the port's report to the JAX package's, and tests/test_torch_cuda.py the
card's to the CPU's.
"""

import numpy as np

#: relative tolerance of a compared value, beside its rounding quantum
EVAL_RTOL = 1e-3


def eval_bounds(ds, card, cpu):
    """Per validation clip, from the two evaluations' rollouts: (largest lpos
    difference d after the warm-in, the jerk-ratio bound 8 * 60^3 * sqrt(3)
    * d over the ground truth's mean jerk, the variance-ratio bound: the
    largest (2 std d + d^2) of a moving joint over its ground-truth
    variance); the derivation of tests/test_torch_quality.py."""
    fps, out = 1.0 / ds.dt, []
    for ri, ((_, p), (_, q)) in enumerate(zip(card, cpu, strict=True)):
        g = ds.get_sample("valid", range_index=ri)[0]["lpos"][0]
        warm = min(int(round(0.5 * fps)), max(0, len(p) - 5))
        p, q, g = p[warm:], q[warm:], g[warm:]
        diff = np.abs(p - q)
        g_jerk = np.linalg.norm(np.diff(g, n=3, axis=0) * fps**3, axis=-1).mean()
        std, d_j = np.maximum(p.std(axis=0), q.std(axis=0)), diff.max(axis=0)
        g_var = g.var(axis=0).mean(-1)
        moving = g_var > 1e-6
        out.append((float(diff.max()), float(8 * fps**3 * np.sqrt(3) * diff.max() / g_jerk),
                    float(((2 * std * d_j + d_j**2).mean(-1)[moving] / g_var[moving]).max())))
    return out


def reports_agree(a, b, bounds):
    """The failed comparisons of two evaluation reports (empty: they agree)."""
    bad = []

    def close(x, y, quantum, key):
        if not abs(x - y) <= quantum + EVAL_RTOL * abs(y):
            bad.append((key, x, y))

    for i, (ca, cb, (_, jerk, var)) in enumerate(zip(a["clips"], b["clips"], bounds, strict=True)):
        bad += [(k, ca[k], cb[k]) for k in ("label", "frames", "warmin_frames_skipped")
                if ca[k] != cb[k]]
        for k in ("lpos_mae", "root_pos_mae"):
            close(ca[k], cb[k], 1e-5, f"clip {i} {k}")
        close(ca["vel_ratio"], cb["vel_ratio"], 1e-4, f"clip {i} vel_ratio")
        if not abs(ca["jerk_ratio"] - cb["jerk_ratio"]) <= jerk + 1e-4:
            bad.append((f"clip {i} jerk_ratio", ca["jerk_ratio"], cb["jerk_ratio"]))
        if not abs(ca["motion_var_ratio_median"] - cb["motion_var_ratio_median"]) <= var + 1e-4:
            bad.append((f"clip {i} motion_var_ratio_median", ca["motion_var_ratio_median"],
                        cb["motion_var_ratio_median"]))
    bad += [(k, a[k], b[k]) for k in ("n_valid_clips", "total_frames") if a[k] != b[k]]
    close(a["lpos_mae_mean"], b["lpos_mae_mean"], 2e-5, "lpos_mae_mean")
    close(a["vel_ratio_mean"], b["vel_ratio_mean"], 2e-4, "vel_ratio_mean")
    if not abs(a["jerk_ratio_mean"] - b["jerk_ratio_mean"]) <= np.mean(
            [x[1] for x in bounds]) + 2e-4:
        bad.append(("jerk_ratio_mean", a["jerk_ratio_mean"], b["jerk_ratio_mean"]))
    if not abs(a["motion_var_ratio_median"] - b["motion_var_ratio_median"]) <= max(
            x[2] for x in bounds) + 2e-4:
        bad.append(("motion_var_ratio_median", a["motion_var_ratio_median"],
                    b["motion_var_ratio_median"]))
    return bad
