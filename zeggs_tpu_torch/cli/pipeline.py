"""Corpus pipeline CLI (counterpart of `zeggs_tpu/cli/pipeline.py`, with the
same flags plus ``--device``).

Usage:
  python -m zeggs_tpu_torch.cli.pipeline -c configs/data_pipeline_conf_v1.json \
      [--workers 8] [--process-index 0 --process-count 1] [--device cuda]

A sharded run writes one archive a shard; once every shard exists,
`--merge-shards N` makes the final artifacts (statistics over the merged
corpus, never per shard).
"""

from __future__ import annotations

import argparse
import json

from ..config import PipelineConfig
from ..data.pipeline import data_pipeline, merge_shards


def main(argv=None):
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.pipeline",
                                description="Prepare a training corpus")
    p.add_argument("-c", "--config", type=str, required=True, help="pipeline conf JSON")
    p.add_argument("--workers", type=int, default=None, help="process-pool size for the clips")
    p.add_argument("--process-index", type=int, default=0, help="this run's shard index")
    p.add_argument("--process-count", type=int, default=1, help="total shards")
    p.add_argument("--merge-shards", type=int, default=None, metavar="N",
                   help="merge N existing shard archives into the final artifacts")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    conf = PipelineConfig.from_json(args.config)
    if args.merge_shards:
        processed, definition = merge_shards(conf, args.merge_shards)
    else:
        processed, definition = data_pipeline(
            conf, num_workers=args.workers, process_index=args.process_index,
            process_count=args.process_count, device=args.device,
        )
    if processed is None:
        print(json.dumps({"shard": args.process_index, "of": args.process_count}))
        return
    n = len(processed["X_audio_features"])
    print(json.dumps({"frames": int(n), "labels": definition["label_names"]}))


if __name__ == "__main__":
    main()
