"""CLI (counterpart of cloudvectordb_tpu/cli.py): the whole pipeline behind
one entry point, each stage independently invocable.

    python -m cloudvectordb_tpu_torch pipeline --config cfg.json [--set a.b=v ...]
    python -m cloudvectordb_tpu_torch {mine,train,encode,build,eval,tune} ...
    python -m cloudvectordb_tpu_torch search --workdir W --query "text" -k 10

Every command runs on ``--device`` (default ``cuda``; ``cpu`` for tests).
``--profile`` writes a ``torch.profiler`` chrome trace under
``workdir/profile``; ``--debug`` turns on autograd's anomaly detection.
``search`` prints only filled result slots: an unfilled slot is (-inf, -1).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from cloudvectordb_tpu_torch.utils.config import PipelineConfig
from cloudvectordb_tpu_torch.utils.metrics import get_logger

log = get_logger("cvdb.cli")


def _parse_value(v: str):
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def _load_cfg(args) -> PipelineConfig:
    if args.config:
        cfg = PipelineConfig.load(args.config)
    else:
        # an existing run's saved config is the source of truth on resume —
        # otherwise `search`/`eval` would look for artifacts under defaults
        saved = Path(args.workdir or PipelineConfig().workdir) / "pipeline_config.json"
        cfg = PipelineConfig.load(saved) if saved.exists() else PipelineConfig()
    if args.workdir:
        cfg.workdir = args.workdir
    overrides = {}
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = cfg.with_overrides(overrides)
    return cfg


def _add_common(p):
    p.add_argument("--config", default=None, help="pipeline config JSON")
    p.add_argument("--workdir", default=None)
    p.add_argument("--set", action="append", metavar="a.b.c=value",
                   help="dotted-path config override (repeatable)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler chrome trace under workdir/profile")
    p.add_argument("--debug", action="store_true",
                   help="enable torch.autograd's anomaly detection")


def _search(pipe, cfg, args) -> None:
    from cloudvectordb_tpu_torch.index.registry import load_index
    from cloudvectordb_tpu_torch.models.embed import text_encoder

    enc = text_encoder(pipe._load_params(), pipe.tokenizer,
                       batch_size=min(32, cfg.encode_batch), device=pipe.device)
    index = load_index(pipe.workdir / "index", device=pipe.device)
    kw = {}
    if index.kind != "flat":
        kw["nprobe"] = args.nprobe or cfg.index.nprobe
    scores, ids = index.search(enc([args.query]), args.k, **kw)
    passages = pipe.passages
    filled = [(s, int(i)) for s, i in zip(scores[0], ids[0]) if i >= 0]
    for rank, (s, i) in enumerate(filled):
        print(f"{rank + 1:3d}. [{s:.4f}] {passages[i][:120]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("cloudvectordb_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("pipeline", "mine", "train", "encode", "build", "eval"):
        _add_common(sub.add_parser(name))
    tp = sub.add_parser("tune")
    _add_common(tp)
    tp.add_argument("--target-recall", type=float, default=0.95,
                    help="recall@k the tuner must reach (eval/tune.py)")
    sp = sub.add_parser("search")
    _add_common(sp)
    sp.add_argument("--query", required=True)
    sp.add_argument("-k", type=int, default=10)
    sp.add_argument("--nprobe", type=int, default=None)
    args = ap.parse_args(argv)

    import torch

    if args.debug:
        torch.autograd.set_detect_anomaly(True)

    cfg = _load_cfg(args)
    from cloudvectordb_tpu_torch.pipeline.run import Pipeline

    pipe = Pipeline(cfg, device=args.device)

    def run_cmd():
        if args.cmd == "pipeline":
            print(json.dumps(pipe.run()))
        elif args.cmd == "mine":
            pipe.stage_mine()
        elif args.cmd == "train":
            pipe.stage_train()
        elif args.cmd == "encode":
            pipe.stage_encode()
        elif args.cmd == "build":
            pipe.stage_build()
        elif args.cmd == "eval":
            print(json.dumps(pipe.stage_eval()))
        elif args.cmd == "tune":
            print(json.dumps(pipe.stage_tune(args.target_recall)))
        elif args.cmd == "search":
            _search(pipe, cfg, args)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if pipe.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        out = pipe.workdir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        with profile(activities=acts) as prof:
            run_cmd()
        prof.export_chrome_trace(str(out / f"{args.cmd}.trace.json"))
    else:
        run_cmd()
    return 0


if __name__ == "__main__":
    sys.exit(main())
