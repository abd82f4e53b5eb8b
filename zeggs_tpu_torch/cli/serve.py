"""Serving CLI: the HTTP gesture-synthesis daemon with dynamic batching
(counterpart of `zeggs_tpu/cli/serve.py`, with the same flags plus
``--device``).

Loads the trained networks once, then serves POST /synthesize requests,
coalescing concurrent requests into bucketed batched rollouts, and live
streaming sessions (see zeggs_tpu_torch/serve/server.py).

Usage:
  python -m zeggs_tpu_torch.cli.serve -o options.json --port 8008
  curl -s localhost:8008/healthz
  curl -s -X POST localhost:8008/synthesize -d '{
      "audio_path": ".../speech.wav", "style_path": ".../style.bvh",
      "temperature": 1.0, "seed": 42}'

Live streaming (session API; see GestureServer._do_stream for the full
payload schema):
  POST /stream/start  {styles, seed?, quantum?}      -> {session_id, frames}
  POST /stream/push   {session_id, audio_f32_b64}    -> {frames}
  POST /stream/finish {session_id, bvh: true}        -> {frames, bvh}
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..config import Options
from ..infer import GesturePipeline
from ..serve import GestureServer


def build_parser():
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.serve",
                                description="Gesture synthesis server")
    p.add_argument("-o", "--options", type=str, required=True, help="options.json from training")
    p.add_argument("-se", "--style_encoding_type", type=str, default="example")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=30.0,
                   help="batching window after the first queued request")
    p.add_argument("--bucket", type=int, default=512,
                   help="rollout length padding quantum (frames)")
    p.add_argument("--int8", action="store_true",
                   help="int8 decoder weights in B=1 rollouts, and int8 products in batched "
                   "rollouts of 256 clips or more")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission bound: bursts beyond it get HTTP 429")
    p.add_argument("--request-timeout-s", type=float, default=900.0,
                   help="handler deadline before a 504")
    paths = p.add_mutually_exclusive_group()
    paths.add_argument("--allow-paths", dest="allow_paths", action="store_true",
                       default=None,
                       help="allow audio_path/bvh_path payload fields that read "
                            "server-visible files (default: loopback binds only)")
    paths.add_argument("--b64-only", dest="allow_paths", action="store_false",
                       help="reject path payload fields even on loopback")
    p.add_argument("--max-sessions", type=int, default=16,
                   help="live streaming sessions bound (429 past it)")
    p.add_argument("--session-ttl-s", type=float, default=600.0,
                   help="idle streaming sessions are dropped after this")
    p.add_argument("--stream-quantum", type=int, default=16,
                   help="min decoder chunk per mid-stream push (frames); "
                        "higher = fewer launches, a few frames more lag")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.options) as f:
        options_dict = json.load(f)
    opts = Options.from_options_dict(options_dict)

    paths = options_dict["paths"]
    data_path = Path(paths["base_path"]) / paths["path_processed_data"]
    network_path = Path(paths["models_dir"])

    pipe = GesturePipeline(
        network_path, data_path, options=opts,
        style_encoding_type=args.style_encoding_type, device=args.device,
        rollout_weights="int8" if args.int8 else None,
    )
    server = GestureServer(
        pipe, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, bucket=args.bucket,
        max_queue=args.max_queue, request_timeout_s=args.request_timeout_s,
        allow_paths=args.allow_paths, max_sessions=args.max_sessions,
        session_ttl_s=args.session_ttl_s, stream_quantum=args.stream_quantum,
    )
    print(f"serving on {args.host}:{server.port} "
          f"(device={pipe.device}, max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms}, "
          f"max_queue={args.max_queue}, allow_paths={server.allow_paths})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
