"""Run the offline convergence ladder and print its summary JSON.

    python -m tiny_audio_tpu_torch.tools.run_convergence --out runs/convergence
    python -m tiny_audio_tpu_torch.tools.run_convergence --device cpu \\
        --n-train 16 --ctc-steps 2 --warmup-steps 2 --s1-steps 2 --s2-steps 2

The port's counterpart of ``scripts/run_convergence.py``, with its flags:
the ladder of :mod:`tiny_audio_tpu_torch.train.convergence` (encoder CTC
pretrain, decoder warmup through the frozen random projector, stage-1
projector-only, stage-2 LoRA) on the tiny fp32 towers and formant-synthesized
labeled speech, held-out greedy-decode WER between the phases, all through
the port's Trainer, collator and pipeline.  ``convergence.json`` lands in
``--out``; ``--save-encoder`` writes the CTC-pretrained encoder in flax's
msgpack layout.  It runs on the card unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import json

from tiny_audio_tpu_torch.device import require_device

SUMMARY_KEYS = ("ctc_token_error_rate", "wer_init", "wer_warmup", "wer_s1", "wer_s2",
                "eval_loss_warmup", "eval_loss_s1", "eval_loss_s2", "phase_seconds")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/convergence")
    ap.add_argument("--n-train", type=int, default=384)
    ap.add_argument("--ctc-steps", type=int, default=2000)
    ap.add_argument("--warmup-steps", type=int, default=600)
    ap.add_argument("--s1-steps", type=int, default=500)
    ap.add_argument("--s2-steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-encoder", default=None,
                    help="save the CTC-pretrained encoder (msgpack) here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    from tiny_audio_tpu_torch.train.convergence import run_convergence_ladder

    rec = run_convergence_ladder(
        args.out,
        n_train=args.n_train,
        ctc_steps=args.ctc_steps,
        warmup_steps=args.warmup_steps,
        s1_steps=args.s1_steps,
        s2_steps=args.s2_steps,
        seed=args.seed,
        save_encoder_path=args.save_encoder,
        device=device,
    )
    summary = {key: rec[key] for key in SUMMARY_KEYS}
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
