"""Run one request through the serving handler on a local checkpoint.

    python -m tiny_audio_tpu_torch.tools.handler_local [-m CHECKPOINT] [--wav FILE] \\
        [--timestamps] [--speakers] [--device cuda]

Port of ``scripts/handler_local.py``: find a checkpoint (the newest
``outputs/*/model`` holding a ``config.json`` when ``-m`` is not given), take
a test wav (a synthesized 2 s tone when ``--wav`` is not given), run one
request through :class:`~tiny_audio_tpu_torch.handler.EndpointHandler` on
``--device`` (the card unless ``--device cpu``) and print the response.
Exits 1 when the response holds an error.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def find_latest_checkpoint(outputs: Path = Path("outputs")) -> Path:
    candidates = sorted(
        (p for p in outputs.glob("*/model") if (p / "config.json").exists()),
        key=lambda p: p.stat().st_mtime,
    )
    if not candidates:
        raise SystemExit("no checkpoints under outputs/ (pass --model)")
    return candidates[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.handler_local")
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("--wav", default=None)
    ap.add_argument("--timestamps", action="store_true")
    ap.add_argument("--speakers", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model_path = Path(args.model) if args.model else find_latest_checkpoint()
    print(f"[handler_local] checkpoint: {model_path}")

    if args.wav:
        inputs = Path(args.wav).read_bytes()
    else:
        t = np.arange(16000 * 2) / 16000
        inputs = (0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
        print("[handler_local] no wav given; using a synthesized 2 s tone")

    from tiny_audio_tpu_torch.handler import EndpointHandler

    handler = EndpointHandler(str(model_path), device=args.device)
    params = {}
    if args.timestamps:
        params["return_timestamps"] = True
    if args.speakers:
        params["return_speakers"] = True
    result = handler({"inputs": inputs, "parameters": params})
    for key, value in result.items():
        print(f"{key}: {value}")
    return 0 if "error" not in result else 1


if __name__ == "__main__":
    raise SystemExit(main())
