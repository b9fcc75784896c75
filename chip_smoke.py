#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the Hopper kernels from ``tiny_audio_tpu_torch/csrc``, holds each
against its plain PyTorch version on random inputs, then drives the port's
serving path at the flagship width (random weights from seed 0):
``ASRModel.generate`` on 4 x 30 s of audio with the int8 KV cache, and
``ASRPipeline`` on three requests.  The inputs the serving path gave each
kernel in its first layer are kept, and each kernel is held against its plain
version once more on exactly those tensors.  Each phase prints one line; the line
before the last is a JSON object with every kernel's launches on the
serving path, error against its plain version and both times; the last line
is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero, and so
does a machine without a CUDA device: nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 4
CLIP_S = 30.0
MAX_NEW = 128
REQUEST_SECONDS = (5, 12, 30)

# bf16 tolerance of a kernel against its plain version on the same bf16
# inputs, |got - want| <= KERNEL_ATOL + KERNEL_RTOL * |want|: both round the
# probabilities to bf16 before the P.V product (the kernel unnormalized, the
# plain version normalized) and round the output to bf16.  bf16 spacing is
# at most 2**-7 of a value, so KERNEL_RTOL allows two ulps of the output, and
# KERNEL_ATOL covers outputs near zero, where the P rounding dominates.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0**-6
# The small-model check runs the same bf16 weights on the card (kernels,
# cuBLAS) and on the CPU (plain versions); matmul order and the kernels'
# rounding points differ, so outputs agree to a few bf16 ulps of their scale.
SMALL_MODEL_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_done() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after warmup."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within the tolerance)."""
    diff = (got.float() - want.float()).abs()
    within = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all())
    return diff.max().item(), within


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def record_first_call(module, name: str, store: dict):
    """Keep a copy of the arguments of the first call to ``module.name``."""
    original = getattr(module, name)

    def recorder(*args, **kwargs):
        if name not in store:
            store[name] = (
                tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                dict(kwargs),
            )
        return original(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, original)


def compare_on_path_inputs(name: str, kernel, plain, call: tuple) -> dict:
    """Kernel vs plain version on the tensors the serving path gave the kernel.
    Padding query rows are don't-care, as in the random-input comparisons."""
    args, kwargs = call
    mask = args[3] if len(args) > 3 else kwargs.get("kv_mask", kwargs.get("padding_mask"))
    valid = (torch.ones(args[0].shape[:2], dtype=torch.bool, device=args[0].device)
             if mask is None else mask.bool())
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    err, within = kernel_error(got[valid], want[valid])
    finite = bool(torch.isfinite(got[valid]).all())
    ms = cuda_ms(lambda: kernel(*args, **kwargs), 20)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), 5)
    print(f"{name} on the serving path's layer-0 inputs shape={list(args[0].shape)} "
          f"real_keys={'all' if mask is None else int(mask.sum())} max_abs_err={err!r} "
          f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL} kernel_ms={ms!r} plain_ms={plain_ms!r}")
    if not finite:
        fail(f"{name} kernel produced non-finite values on the serving path's inputs")
    if not within:
        fail(f"{name} kernel disagrees with its plain version on the serving path's inputs: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def compare_encoder_kernel(gen: torch.Generator) -> dict:
    from tiny_audio_tpu_torch.ops.encoder_attention import (
        encoder_attention,
        encoder_attention_plain,
    )

    b, t, h, d = 2, 1500, 20, 64
    q, k, v = (
        torch.randn((b, t, h * d), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    q = q * 2  # sharper softmax rows than unit scores
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    mask[1, 900:] = 0  # ragged per-row lengths: 1500 and 900 real frames
    got = encoder_attention(q, k, v, mask, h)
    want = encoder_attention_plain(q, k, v, mask, h)
    valid = mask.bool()
    err, within = kernel_error(got[valid], want[valid])
    if not torch.isfinite(got).all():
        fail("encoder attention kernel produced non-finite values")
    ms = cuda_ms(lambda: encoder_attention(q, k, v, mask, h), 20)
    plain_ms = cuda_ms(lambda: encoder_attention_plain(q, k, v, mask, h), 5)
    print(f"encoder_attention B={b} T={t} H={h} D={d} bf16 max_abs_err={err!r} "
          f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL} kernel_ms={ms!r} plain_ms={plain_ms!r}")
    if not within:
        fail(f"encoder attention kernel disagrees with its plain version: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def compare_prefill_kernel(gen: torch.Generator) -> dict:
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_plain,
    )

    b, t, hq, hkv, d = 2, 468, 16, 8, 128
    q = torch.randn((b, t, hq, d), generator=gen, device="cuda").to(torch.bfloat16) * 2
    k, v = (
        torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(2)
    )
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    mask[1, 400:] = 0  # one row right-padded
    got = prefill_attention(q, k, v, mask)
    want = prefill_attention_plain(q, k, v, mask)
    valid = mask.bool()  # padding query rows are don't-care
    err, within = kernel_error(got[valid], want[valid])
    if not torch.isfinite(got[valid]).all():
        fail("prefill attention kernel produced non-finite values")
    ms = cuda_ms(lambda: prefill_attention(q, k, v, mask), 20)
    plain_ms = cuda_ms(lambda: prefill_attention_plain(q, k, v, mask), 5)
    print(f"prefill_attention B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal bf16 "
          f"max_abs_err={err!r} atol={KERNEL_ATOL} rtol={KERNEL_RTOL} "
          f"kernel_ms={ms!r} plain_ms={plain_ms!r}")
    if not within:
        fail(f"prefill attention kernel disagrees with its plain version: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def small_model_reference() -> None:
    """The serving path on a small bf16 model, card vs CPU on equal weights."""
    from tiny_audio_tpu_torch import ASRConfig, DecoderConfig, EncoderConfig
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.processing import ASRProcessor

    cfg = ASRConfig(
        encoder=EncoderConfig(num_mel_bins=128, d_model=256, num_layers=2, num_heads=4,
                              ffn_dim=512, max_source_positions=1500),
        decoder=DecoderConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                              num_kv_heads=2, head_dim=128, intermediate_size=512),
        kv_cache_dtype="int8",
    )
    cuda_model = ASRModel(cfg, seed=SEED, device="cuda")
    cpu_model = ASRModel(cfg, seed=SEED, device="cpu")
    cpu_model.load_state_dict(cuda_model.state_dict())
    audio = [np.random.default_rng(SEED).standard_normal(n).astype(np.float32) * 0.1
             for n in (16000 * 7, 16000 * 3)]
    embeds = {}
    tokens = {}
    for name, model in (("cuda", cuda_model), ("cpu", cpu_model)):
        feats = ASRProcessor(model.projector, device=model.device).extract_features(audio)
        with torch.inference_mode():
            embeds[name] = model._encode_audio(
                feats["input_features"], feats["audio_attention_mask"]
            ).float().cpu()
        tokens[name] = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                      max_new_tokens=16)
    rel = ((embeds["cuda"] - embeds["cpu"]).abs().max() / embeds["cpu"].abs().max()).item()
    agree = float((tokens["cuda"] == tokens["cpu"]).mean())
    print(f"small_model audio_embeds rel_err={rel!r} rtol={SMALL_MODEL_RTOL} "
          f"token_agreement_vs_cpu={agree!r}")
    if not rel <= SMALL_MODEL_RTOL:
        fail(f"small model's audio embeddings on the card disagree with the CPU: {rel}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device; this smoke run measures the GPU and never runs on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    power_line = gpu_name_and_power()
    print(f"gpu {power_line} torch={torch.__version__} cuda={torch.version.cuda}")

    # ---- 2. build ----
    from tiny_audio_tpu_torch import kernels

    t0 = time.perf_counter()
    _, nvcc_s, log = kernels.build()
    kernels.library()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"build nvcc_s={nvcc_s!r} total_s={time.perf_counter() - t0!r} "
          f"ptxas={json.dumps(ptxas)}")
    phase_done()

    # ---- 3, 4. kernels vs their plain versions ----
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    enc = compare_encoder_kernel(gen)
    phase_done()
    pre = compare_prefill_kernel(gen)
    phase_done()
    small_model_reference()
    phase_done()

    # ---- 5. the serving path at the flagship width ----
    from tiny_audio_tpu_torch import ASRConfig
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.ops import attention as attention_dispatch
    from tiny_audio_tpu_torch.ops.encoder_attention import (
        encoder_attention,
        encoder_attention_plain,
    )
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_plain,
    )
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    t0 = time.perf_counter()
    cfg = ASRConfig(kv_cache_dtype="int8")
    model = ASRModel(cfg, seed=SEED, device="cuda")
    phase_done()
    init_s = time.perf_counter() - t0
    pipe = ASRPipeline(model)
    n = int(CLIP_S * 16000)
    rng = np.random.default_rng(SEED)
    pcm = (np.clip(rng.standard_normal((BATCH, n)) * 0.1, -1, 1) * 32767).astype(np.int16)
    audio = [row.astype(np.float32) / 32768.0 for row in pcm]
    # min_new_tokens = the budget masks EOS: every row decodes all 128 tokens
    gen_kwargs = dict(min_new_tokens=MAX_NEW, max_new_tokens=MAX_NEW)

    encoder_attention.launches = 0
    prefill_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats = pipe.processor.extract_features(audio)
    tokens = model.generate(feats["input_features"], feats["audio_attention_mask"],
                            mel_length=int(feats["mel_lengths"].max()), **gen_kwargs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"encoder_attention": encoder_attention.launches,
                "prefill_attention": prefill_attention.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    n_enc, n_dec = cfg.encoder.num_layers, cfg.decoder.num_layers
    if launches != {"encoder_attention": n_enc, "prefill_attention": n_dec}:
        fail(f"serving path launches {launches}, expected {n_enc} encoder and "
             f"{n_dec} prefill launches (one per layer)")
    if tokens.shape != (BATCH, MAX_NEW):
        fail(f"tokens have shape {tokens.shape}, expected {(BATCH, MAX_NEW)}")
    if tokens.min() < 0 or tokens.max() >= cfg.decoder.vocab_size:
        fail("tokens outside the vocabulary")

    # The second call, timed, also keeps the first layer's kernel inputs (the
    # counted call above ran with nothing patched).
    path_inputs: dict = {}
    with record_first_call(attention_dispatch, "encoder_attention", path_inputs), \
            record_first_call(attention_dispatch, "prefill_attention", path_inputs):
        t0 = time.perf_counter()
        feats = pipe.processor.extract_features(audio)
        tokens2 = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                 mel_length=int(feats["mel_lengths"].max()), **gen_kwargs)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    if set(path_inputs) != {"encoder_attention", "prefill_attention"}:
        fail(f"the serving path did not reach both kernels' wrappers: {sorted(path_inputs)}")
    if not np.array_equal(tokens, tokens2):
        fail("two generate calls on the same batch gave different tokens")
    with torch.inference_mode():
        hidden = model.encoder(feats["input_features"], feats["audio_attention_mask"])
    if not torch.isfinite(hidden).all():
        fail("encoder output is not finite")
    if "jax" in sys.modules:
        fail("the port imported jax")
    print(f"generate batch={BATCH} clip_s={CLIP_S} new_tokens={MAX_NEW} kv=int8 bf16 "
          f"init_s={init_s!r} first_call_s={first_s!r} batch_wall_s={batch_s!r} "
          f"peak_mem_gib={peak_gib!r} launches={json.dumps(launches)} "
          f"deterministic=true encoder_finite=true")
    phase_done()

    # ---- 5b. kernels vs plain versions on the serving path's own inputs ----
    enc_path = compare_on_path_inputs("encoder_attention", encoder_attention,
                                      encoder_attention_plain, path_inputs["encoder_attention"])
    pre_path = compare_on_path_inputs("prefill_attention", prefill_attention,
                                      prefill_attention_plain, path_inputs["prefill_attention"])
    del path_inputs
    phase_done()

    # ---- 6. the pipeline answers three requests ----
    texts = []
    t0 = time.perf_counter()
    for seconds in REQUEST_SECONDS:
        clip = rng.standard_normal(int(seconds * 16000)).astype(np.float32) * 0.1
        result = pipe(clip)
        if not isinstance(result, dict) or not isinstance(result.get("text"), str):
            fail(f"pipeline gave {result!r} for a {seconds} s request")
        texts.append(len(result["text"]))
    phase_done()
    print(f"pipeline requests={len(REQUEST_SECONDS)} seconds={list(REQUEST_SECONDS)} wall_s={time.perf_counter() - t0!r} "
          f"text_chars={texts}")

    # Times are at the serving path's inputs; the error is the larger of the
    # random-input and the serving-path comparisons.
    source = "tiny_audio_tpu_torch/csrc/attention.cu"
    print(json.dumps({"kernels": [
        {"name": "encoder_attention", "route": "cuda", "source": source,
         "replaces": "tiny_audio_tpu/ops/encoder_attention.py:159",
         "launches": launches["encoder_attention"], **enc_path,
         "max_abs_err": max(enc["max_abs_err"], enc_path["max_abs_err"])},
        {"name": "prefill_attention", "route": "cuda", "source": source,
         "replaces": "tiny_audio_tpu/ops/attention.py:65",
         "launches": launches["prefill_attention"], **pre_path,
         "max_abs_err": max(pre["max_abs_err"], pre_path["max_abs_err"])},
    ]}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
