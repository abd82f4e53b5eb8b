"""Roofline of the v1 train step on an H100 (counterpart of
`scripts/train_roofline.py`).

    python -m zeggs_tpu_torch.profilers.train_roofline [--bf16] [--measured-ms 343.5] [--json]

Builds the bench's train step (`bench/train.py::Step`: B=32 x 256 frames at
full v1 dims over the device corpus; ``--bf16`` for bfloat16 decoder
products), so that bench and roofline cannot drift apart, and bounds it:

    bound = max(flops / PEAK_OPS[dtype], bytes / HBM_BYTES_PER_S)

with the H100's peaks from `device.py` (989 TFLOP/s bfloat16 dense, 67
TFLOP/s float32 outside the tensor cores: TF32 is off; 3.35 TB/s HBM).

* FLOPs: `torch.utils.flop_counter.FlopCounterMode` over one eager step
  (`Step.eager`, the plain `train/loop.py::make_train_step`), forward and
  backward: the products (linear, convolution, batched matmul) only.
* Bytes: PyTorch has no counterpart of XLA's ``cost_analysis()["bytes
  accessed"]`` (eager PyTorch compiles no program to ask), so
  ``bytes_accessed`` is null and the bound's bytes come from the script's
  analytic weight-streaming model: each of the 256 frames moves the
  decoder cell's weights (`CELL_PARAMS`, counted from the port's decoder)
  once forward, once transposed for the input gradient, and reads and
  writes its weight gradient (``DW_ROUNDTRIPS = 2``: autograd adds each
  frame's weight gradient into one accumulator, a read and a write each
  frame; the script's ``--unroll``, which let XLA fuse 4 frames' updates,
  has no counterpart), plus one RAdam pass over every parameter (8 float32
  arrays read or written). At bfloat16 the cell's 37.8 MB of weights fit
  the H100's 50 MB L2, so this HBM model overstates the bfloat16 bytes.

``--measured-ms`` adds ``fraction_of_bound`` (bound over the measured step).
Prints the keys one a line, or one JSON line with ``--json``, then
TRAIN_ROOFLINE_DONE. ``--device cpu --tiny`` rehearses on the CPU at narrow
widths.
"""

from __future__ import annotations

import json

from torch.utils.flop_counter import FlopCounterMode

from ..bench import fixture as FX
from ..bench.train import Step
from ..device import HBM_BYTES_PER_S, PEAK_OPS
from . import common

#: reads and writes of the weight-gradient accumulator a frame
DW_ROUNDTRIPS = 2
#: float32 arrays RAdam reads or writes a parameter: the parameter, its
#: gradient and the two moments read; the parameter and moments written;
#: the cast of the weights read
OPTIMIZER_ARRAYS = 8


def analytic_bytes(cell_params, n_params, frames, dtype):
    """The weight-streaming model's bytes for one step."""
    wbytes = cell_params * (2 if dtype == "bfloat16" else 4)
    return frames * wbytes * (1 + 1 + DW_ROUNDTRIPS) + n_params * 4 * OPTIMIZER_ARRAYS


def step_flops(step: Step):
    """FLOPs of one eager step, forward and backward."""
    eager = step.eager()
    inputs = step.draw()
    counter = FlopCounterMode(display=False)
    with counter:
        eager(inputs, 0)
    return counter.get_total_flops()


def roofline(dtype, device, tiny=False, measured_ms=None):
    step = Step(dtype, device, tiny)
    flops = step_flops(step)
    dec = step.nets["decoder"]
    cell = common.cell_weights(dec)
    n_params = sum(p.numel() for m in step.nets.values() for p in m.parameters())
    frames = step.ds.window
    analytic = analytic_bytes(cell, n_params, frames, dtype)
    peak = PEAK_OPS[dtype]
    t_flops, t_bytes = flops / peak, analytic / HBM_BYTES_PER_S
    bound_ms = max(t_flops, t_bytes) * 1e3
    out = {
        "dtype": dtype, "batch": step.batchsize, "frames": frames,
        "flops": flops, "bytes_accessed": None,
        "cell_params": cell, "n_params": n_params, "dw_roundtrips": DW_ROUNDTRIPS,
        "peak_flops": peak, "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "t_flops_ms": t_flops * 1e3, "t_bytes_ms": t_bytes * 1e3,
        "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "analytic_bytes": analytic, "analytic_bytes_ms": t_bytes * 1e3,
        "arith_intensity_flops_per_byte": flops / analytic,
    }
    if measured_ms is not None:
        out["measured_ms"] = measured_ms
        out["fraction_of_bound"] = bound_ms / measured_ms
    return out


def main(argv=None):
    ap = FX.stage_parser(__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true", help="bfloat16 decoder products")
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="a measured step time to compare against")
    ap.add_argument("--json", action="store_true")
    args, device = common.parse(ap, argv)
    dtype = "bfloat16" if args.bf16 else "float32"
    out = roofline(dtype, device, args.tiny, args.measured_ms)
    out["device"] = FX.device_summary(device)
    if args.json:
        print(json.dumps(out))
    else:
        print(f"peak used: {dtype} {out['peak_flops'] / 1e12:g} TFLOP/s, "
              f"HBM {HBM_BYTES_PER_S / 1e12:g} TB/s (H100)")
        for k, v in out.items():
            print(f"{k}: {v}")
    print("TRAIN_ROOFLINE_DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
