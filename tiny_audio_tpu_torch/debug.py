"""Debug tools: router health, gradient flow, weight health, LoRA analysis.

Port of :mod:`tiny_audio_tpu.debug`; every report equals the JAX
package's for the same model (the trees are the JAX params layout, from
:func:`tiny_audio_tpu_torch.bridge.state_dict_to_jax`):

- :func:`check_router_health`: audio through a MoE / MOSA projector, the
  routing probabilities (read by a forward hook on the projector's
  ``router_probs`` identity) against health targets: normalized entropy in
  [0.6, 0.85], per-expert mean usage in [10 %, 40 %], collapse.
- :func:`check_gradient_flow`: one synthetic forward/backward, per-tower
  gradient norms, leak checks and a NaN/Inf scan.
- :func:`analyze_weights`: per-tower norms, zero and outlier fractions.
- :func:`analyze_lora`: per-target ||B|| ||A||.
- :func:`compare_to_base`: per-leaf relative drift between two checkpoints.

The JAX package's ``calibrate_attention_window`` (``debug attn-window``)
checks encoder scores against its TPU kernel's constant-shift softmax
window; the port's encoder kernel computes an exact softmax, so it is left
out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tiny_audio_tpu_torch.bridge import _flatten, jax_leaf, state_dict_to_jax

ENTROPY_HEALTH = (0.60, 0.85)  # fraction of max entropy (reference targets)
USAGE_HEALTH = (0.10, 0.40)


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _np32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


def _synthetic_audio(seconds: float, noise: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.2 * np.sin(2 * np.pi * 160 * t)
            + noise * rng.standard_normal(len(t))).astype(np.float32)


# ------------------------------------------------------------- router health


def router_stats(probs: np.ndarray) -> dict:
    """[N, E] routing probabilities -> health statistics."""
    probs = np.asarray(probs, np.float64).reshape(-1, probs.shape[-1])
    n, e = probs.shape
    entropy = -(probs * np.log(probs + 1e-12)).sum(axis=1).mean()
    max_entropy = np.log(e)
    usage = probs.mean(axis=0)
    top1_share = np.bincount(probs.argmax(axis=1), minlength=e) / n
    return {
        "normalized_entropy": float(entropy / max_entropy),
        "per_expert_usage": usage.tolist(),
        "top1_share": top1_share.tolist(),
        "collapsed": bool(top1_share.max() > 0.9),
        "entropy_healthy": bool(ENTROPY_HEALTH[0] <= entropy / max_entropy
                                <= ENTROPY_HEALTH[1]),
        "usage_healthy": bool((usage >= USAGE_HEALTH[0]).all()
                              and (usage <= USAGE_HEALTH[1]).all()),
    }


@torch.inference_mode()
def check_router_health(model, audio: Optional[np.ndarray] = None,
                        seconds: float = 4.0) -> dict:
    """Run audio (default: a seeded tone in noise) through the model's
    encoder and projector on its device and report routing health.  Needs
    a ``moe`` or ``mosa`` projector."""
    from tiny_audio_tpu_torch.processing import ASRProcessor

    if model.config.projector_type not in ("moe", "mosa"):
        raise ValueError(f"router health needs a moe/mosa projector, got "
                         f"{model.config.projector_type!r}")
    if audio is None:
        audio = _synthetic_audio(seconds, 0.01)
    proc = ASRProcessor(model.tokenizer, projector=model.projector,
                        num_mel_bins=model.config.encoder.num_mel_bins,
                        encoder_conv_layers=model.config.encoder_conv_layers,
                        device=model.device)
    feats = proc.extract_features(audio)
    hidden = model.encoder(feats["input_features"], frame_mask=feats["audio_attention_mask"])
    captured: list = []
    hook = model.projector.router_probs.register_forward_hook(
        lambda module, args, out: captured.append(out.float().cpu().numpy()))
    try:
        model.projector(hidden, train=False)
    finally:
        hook.remove()
    if not captured:
        raise RuntimeError("the projector's router_probs hook saw no call")
    return router_stats(captured[0])


# ------------------------------------------------------------- gradient flow


def check_gradient_flow(model, batch: Optional[dict] = None) -> dict:
    """One synthetic forward/backward on the model's device: per-tower
    gradient norms, leak and NaN/Inf checks.

    The JAX package takes the gradient over every parameter and stops it
    inside ``compute_loss``: the encoder always, the decoder's base under
    ``freeze_language_model``.  Here those parameters keep
    ``requires_grad`` off for the pass (the projector and the LoRA leaves on,
    as JAX differentiates them), and a parameter without a gradient counts
    as zeros, so the frozen towers read 0.0 as in JAX's report.  A tower's
    norm is the root of its leaves' summed squares, reduced on the device;
    leaves are named by their JAX path.  The model's own ``requires_grad``
    flags are restored afterwards."""
    if batch is None:
        rng = np.random.default_rng(0)
        b, t_mel = 2, 50
        feats = rng.standard_normal((b, model.config.encoder.num_mel_bins, t_mel)).astype(
            np.float32)
        ids = np.asarray(model.build_prompt_ids(model._num_audio_tokens(t_mel)) + [5, 6, 7],
                         np.int32)[None].repeat(b, 0)
        labels = np.full_like(ids, -100)
        labels[:, -3:] = ids[:, -3:]
        batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels,
                 "input_features": feats, "audio_attention_mask": np.ones((b, t_mel), np.int32)}

    freeze_lm = model.config.freeze_language_model
    flags = {name: p.requires_grad for name, p in model.named_parameters()}
    modules = dict(model.named_modules())
    sumsq: dict = {}  # tower -> sum of squared gradient norms, in float64
    base_sumsq = 0.0  # the decoder's base (non-LoRA) leaves
    report: dict = {"module_grad_norms": {}, "problems": []}
    try:
        for name, p in model.named_parameters():
            tower = name.split(".", 1)[0]
            p.requires_grad_(tower == "projector" or (
                tower == "decoder" and ("lora" in name or not freeze_lm)))
            p.grad = None
        loss, _ = model.compute_loss(batch, train=False)
        loss.backward()
        for name, p in model.named_parameters():
            path = "/".join(jax_leaf(modules, name)[0])
            sq = 0.0
            if p.grad is not None:
                g = p.grad.detach().float()
                sq = float(g.square().sum())
                problem = f"non-finite grad at {path}"
                if not bool(torch.isfinite(g).all()) and problem not in report["problems"]:
                    report["problems"].append(problem)
            top = path.split("/")[0]
            sumsq[top] = sumsq.get(top, 0.0) + sq
            if top == "decoder" and "lora" not in path:
                base_sumsq += sq
    finally:
        for name, p in model.named_parameters():
            p.requires_grad_(flags[name])
            p.grad = None

    report["module_grad_norms"] = {k: float(np.sqrt(v)) for k, v in sumsq.items()}
    if report["module_grad_norms"].get("encoder", 0.0) > 1e-8:
        report["problems"].append("frozen encoder received gradient (leak)")
    if freeze_lm and base_sumsq > 1e-8:
        report["problems"].append("frozen LM base received gradient (leak)")
    if report["module_grad_norms"].get("projector", 0.0) < 1e-10 and not (
            model.config.freeze_projector):
        report["problems"].append("projector received no gradient")
    report["ok"] = not report["problems"]
    return report


# ------------------------------------------------------------ weight health


def analyze_weights(params) -> dict:
    """Per-tower static stats of a params tree: rms, zero fraction,
    outlier fraction (> 6 std from a leaf's mean), non-finite count."""
    report = {}
    for path, leaf in _tree_paths(params):
        arr = _np32(leaf)
        entry = report.setdefault(path.split("/")[0], {
            "n_params": 0, "sumsq": 0.0, "zeros": 0, "outliers": 0, "nonfinite": 0})
        entry["n_params"] += arr.size
        entry["sumsq"] += float((arr.astype(np.float64) ** 2).sum())
        entry["zeros"] += int((arr == 0).sum())
        entry["nonfinite"] += int((~np.isfinite(arr)).sum())
        std = arr.std() or 1.0
        entry["outliers"] += int((np.abs(arr - arr.mean()) > 6 * std).sum())
    for entry in report.values():
        n = max(entry["n_params"], 1)
        entry["rms"] = float(np.sqrt(entry["sumsq"] / n))
        entry["zero_fraction"] = entry["zeros"] / n
        entry["outlier_fraction"] = entry["outliers"] / n
        del entry["sumsq"], entry["zeros"], entry["outliers"]
    return report


def analyze_lora(params) -> dict:
    """Per-target effective update magnitude ||B|| * ||A||."""
    flat = dict(_flatten(params.get("decoder", params)))
    report = {}
    for key, leaf in flat.items():
        name = "/".join(key)
        if name.endswith("_lora_a"):
            b_key = key[:-1] + (key[-1].replace("_lora_a", "_lora_b"),)
            if b_key in flat:
                a, b = _np32(leaf), _np32(flat[b_key])
                report[name[: -len("_lora_a")]] = {
                    "a_norm": float(np.linalg.norm(a)),
                    "b_norm": float(np.linalg.norm(b)),
                    "delta_norm": float(np.linalg.norm(a) * np.linalg.norm(b)),
                    "b_is_zero": bool(np.abs(b).max() == 0),
                }
    return report


def compare_to_base(params_a, params_b) -> dict:
    """Per-leaf relative weight drift between two params trees."""
    report = {}
    flat_a, flat_b = dict(_tree_paths(params_a)), dict(_tree_paths(params_b))
    for path in sorted(set(flat_a) & set(flat_b)):
        a, b = _np32(flat_a[path]), _np32(flat_b[path])
        if a.shape != b.shape:
            report[path] = {"shape_mismatch": True}
            continue
        base = float(np.linalg.norm(a)) or 1.0
        drift = float(np.linalg.norm(a - b)) / base
        if drift > 0:
            report[path] = {"relative_drift": drift}
    return report


# --------------------------------------------------------------------- CLI


def add_debug_parser(subparsers) -> None:
    p = subparsers.add_parser("debug", help="Model debugging tools")
    sp = p.add_subparsers(dest="debug_cmd", required=True)

    def command(name, func):
        c = sp.add_parser(name)
        c.add_argument("-m", "--model", required=True)
        c.add_argument("--device", default="cuda",
                       help="the model's device: the card unless 'cpu' is asked for")
        c.set_defaults(func=func)
        return c

    for name in ("check-moe", "check-mosa"):
        command(name, _cmd_router)
    command("check-gradient-flow", _cmd_gradient)
    command("analyze-weights", _cmd_weights)
    command("analyze-lora", _cmd_lora)
    command("compare-to-base", _cmd_compare).add_argument("-b", "--base", required=True)


def _load(path, device):
    from tiny_audio_tpu_torch.models.asr import ASRModel

    return ASRModel.from_pretrained(path, device=device)


def _print_dict(d, indent=0):
    for k, v in d.items():
        if isinstance(v, dict):
            print("  " * indent + f"{k}:")
            _print_dict(v, indent + 1)
        else:
            print("  " * indent + f"{k}: {v}")


def _cmd_router(args) -> int:
    report = check_router_health(_load(args.model, args.device))
    _print_dict(report)
    healthy = report["entropy_healthy"] and report["usage_healthy"] and not report["collapsed"]
    print("HEALTHY" if healthy else "UNHEALTHY")
    return 0 if healthy else 1


def _cmd_gradient(args) -> int:
    report = check_gradient_flow(_load(args.model, args.device))
    _print_dict(report)
    return 0 if report["ok"] else 1


def _cmd_weights(args) -> int:
    _print_dict(analyze_weights(state_dict_to_jax(_load(args.model, args.device))))
    return 0


def _cmd_lora(args) -> int:
    _print_dict(analyze_lora(state_dict_to_jax(_load(args.model, args.device))))
    return 0


def _cmd_compare(args) -> int:
    report = compare_to_base(state_dict_to_jax(_load(args.base, args.device)),
                             state_dict_to_jax(_load(args.model, args.device)))
    for path, row in sorted(report.items(),
                            key=lambda kv: -kv[1].get("relative_drift", 0))[:40]:
        _print_dict({path: row})
    return 0
