"""Offline transcription: a closed loop of whole batches through the port.

A lap copies the next batch's int16 PCM to the card on a side stream while
the current batch runs the port's front end (``ops/mel.py``), then
``ASRModel.generate`` (the default fused decode, the configuration's KV
cache, EOS masked by ``min_new_tokens = max_new_tokens`` so that every lap
does the same work), then ``ASRPipeline.postprocess_tokens`` on each row.

Correct: after the window, a sample of the finished requests drawn from the
seed (the longest clip's row always in it) is run through the plain
reference over its prompt and served tokens; the widest gap by which a
served token's logit lies below the reference's best (EOS masked, as the
program masks it), and the share of served tokens that are not the
reference's best, are held to the workload's limits.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import flops, reference, traffic, weights

KIND = "serve"
END_TO_END = {"rtfx": "audio_s/s", "setup_s": "s"}
#: the two arrangements of the pool the laps alternate between
ARRANGEMENTS = 2
#: the port's launch counters of the kernels the phases and rooflines read:
#: a traced run logs them beside the trace's events (a cross-check)
WRAPPERS = {"encoder_attn": ("tiny_audio_tpu_torch.ops.encoder_attention", "encoder_attention"),
            "prefill_attn": ("tiny_audio_tpu_torch.ops.prefill_attention", "prefill_attention"),
            "decode_attn": ("tiny_audio_tpu_torch.ops.decode_attention",
                            "decode_attention_update")}


def asr_config(cfg: dict):
    from tiny_audio_tpu_torch.config import ASRConfig

    return ASRConfig.from_dict(cfg)  # keys that are no ASRConfig field are left out


class Upload:
    """Copies of int16 batches onto the device: on the card from pinned host
    memory on a side stream; :meth:`take` makes the current stream wait for
    the copy and records the tensor's use there."""

    def __init__(self, batches: list, device: torch.device):
        self.device = device
        self.host = [torch.from_numpy(b) for b in batches]
        self.stream = None
        if device.type == "cuda":
            self.host = [h.pin_memory() for h in self.host]
            self.stream = torch.cuda.Stream(device)

    def put(self, i: int) -> tuple:
        if self.stream is None:
            return self.host[i].clone(), None
        with torch.cuda.stream(self.stream):
            x = self.host[i].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return x, done

    def take(self, pending: tuple) -> torch.Tensor:
        x, done = pending
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            x.record_stream(current)
        return x

    def close(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


class Lap:
    def __init__(self, spec: dict, cfg: dict, seed: int, device: torch.device):
        self.spec, self.cfg, self.seed, self.device = spec, cfg, seed, device
        self.pool = traffic.ServePool(spec["traffic"], seed)
        self.new_tokens = self.pool.max_new_tokens
        self.outputs: list = []  # (arrangement, tokens [B, G]) of each finished lap

    # ---------------------------------------------------------- program

    def setup(self) -> None:
        from tiny_audio_tpu_torch.models.asr import ASRModel
        from tiny_audio_tpu_torch.pipeline import ASRPipeline

        pool, dev = self.pool, self.device
        clock = SetupClock(dev)
        tree = weights.make_params(self.cfg, self.seed, dev, dtype_of(self.cfg))
        n_params = weights.count(tree)
        clock.mark("weights")
        self.model = ASRModel(asr_config(self.cfg), params=tree, device=dev)
        del tree
        clock.mark("model")
        if n_params != self.cfg["parameters"]:
            raise SystemExit(f"seeded tree holds {n_params} parameters, the configuration "
                             f"{self.cfg['parameters']}")
        self.pipe = ASRPipeline(self.model)
        rows = [pool.rows(k) for k in range(ARRANGEMENTS)]
        self.upload = Upload([np.ascontiguousarray(pool.pcm[r]) for r in rows], dev)
        self.lengths = [torch.as_tensor(pool.lengths[r], dtype=torch.int32, device=dev)
                        for r in rows]
        self.n_frames = pool.padded // 160
        self.mel_length = int(pool.mel_frames.max())
        self.pending = self.upload.put(0)
        self.laps = 0
        clock.mark("upload")
        self._lap(max_new=2)  # warm-up: the cell's batch and prompt shapes
        clock.mark("warm-up")

    def _lap(self, max_new: int):
        from tiny_audio_tpu_torch.ops import mel

        k = self.laps % ARRANGEMENTS
        current = self.upload.take(self.pending)
        self.pending = self.upload.put((self.laps + 1) % ARRANGEMENTS)
        with torch.inference_mode():
            feats = mel.log_mel_spectrogram(current.to(torch.float32) / 32768.0,
                                            num_mel_bins=self.cfg["encoder"]["num_mel_bins"])
            mask = mel.frame_attention_mask(self.lengths[k], self.n_frames)
        tokens = self.model.generate(feats, mask, mel_length=self.mel_length,
                                     max_new_tokens=max_new, min_new_tokens=max_new)
        for row in tokens:
            self.pipe.postprocess_tokens(row)
        self.laps += 1
        return k, tokens

    def unit(self) -> None:
        self.outputs.append(self._lap(self.new_tokens))

    def metrics(self, units: int, window_s: float) -> dict:
        return {"rtfx": units * self.pool.audio_s() / window_s}

    def counts(self, units: int) -> tuple:
        """(requests attempted, failed) in the window."""
        return units * self.pool.batch, units * self.pool.batch - sum(
            len(t) for _, t in self.outputs)

    def release(self) -> None:
        self.upload.close()
        del self.model, self.pipe, self.upload, self.pending, self.lengths

    # ---------------------------------------------------------- shapes

    def prompt_len(self, n_audio: int) -> int:
        return len(reference.chat(self.cfg["system_prompt"], reference.user_turn(n_audio), None))

    def context(self, n_units: int) -> dict:
        """Per traced lap: each kernel's calls' least seconds, the model FLOPs."""
        cfg, pool, g = self.cfg, self.pool, self.new_tokens
        e, d = cfg["encoder"], cfg["decoder"]
        stride = cfg["projector_pool_stride"]
        b, t_enc = pool.batch, reference.conv_len(self.n_frames)
        n_audio = reference.audio_tokens(reference.conv_len(self.mel_length), stride)
        t_real = self.prompt_len(n_audio)  # the program pads it; no output of the pad is used
        hq, hkv, hd = d["num_heads"], d["num_kv_heads"], d["head_dim"]
        keys = [int(reference.conv_len(int(m))) for m in pool.mel_frames]
        enc = flops.least_s(*flops.encoder_attention(b, t_enc, e["num_heads"],
                                                     e["d_model"] // e["num_heads"], keys))
        pre = flops.least_s(*flops.prefill_attention(b, t_real, hq, hkv, hd))
        dec = [flops.least_s(*flops.decode_attention_update(b, t_real + s - 1, hq, hkv, hd))
               for s in range(1, g) for _ in range(d["num_layers"])]
        calls = {"encoder_attn": [enc] * e["num_layers"],
                 "prefill_attn": [pre] * d["num_layers"], "decode_attn": dec}
        lap_flops = 0.0
        for m in pool.mel_frames:
            own = reference.audio_tokens(reference.conv_len(int(m)), stride)
            lap_flops += flops.serve_row_flops(cfg, int(m), t_real - n_audio + own, g)
        return {"expected": [calls] * n_units, "model_flops": [lap_flops] * n_units,
                "decode_steps": g - 1}

    @staticmethod
    def phases(unit) -> list:
        """The lap's phases by their first events: encode, prefill, decode."""
        bounds = [(unit.start, "encode")]
        for key, name in (("prefill_attn", "prefill"), ("decode_attn", "decode")):
            if unit.of(key):
                bounds.append((unit.of(key)[0].start, name))
        return bounds

    # ---------------------------------------------------------- correct

    def sample(self) -> list:
        """(lap, row) pairs of finished requests drawn from the seed, the
        longest clip's row among them."""
        n = int(self.spec["check"]["sample_rows"])
        laps = len(self.outputs)
        r = traffic.rng(self.seed, 7)
        picks = {(int(r.integers(laps)), int(i)) for i in r.choice(self.pool.batch, n - 1,
                                                                   replace=False)}
        longest = int(np.argmax(self.pool.lengths))
        lap = int(r.integers(laps))
        picks.add((lap, int(np.nonzero(self.pool.rows(self.outputs[lap][0]) == longest)[0][0])))
        return sorted(picks)

    def check(self) -> dict:
        picks = self.sample()
        read = served_gaps(self.cfg, self.seed, self.device, self.pool, self.mel_length,
                           [(self.pool.rows(self.outputs[lap][0])[row],
                             self.outputs[lap][1][row]) for lap, row in picks])
        limits = self.spec["check"]["limits"]
        return {name: {"value": read[name], "limit": limit} for name, limit in limits.items()}


class SetupClock:
    """Seconds of each part of set-up, on standard error (the device
    synchronized at each mark)."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def mark(self, part: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"setup {part} {now - self.t!r} s", file=sys.stderr, flush=True)
        self.t = now


def dtype_of(cfg: dict) -> torch.dtype:
    return torch.bfloat16 if cfg["model_dtype"] == "bfloat16" else torch.float32


#: requests the reference takes at a time (memory, not results)
BLOCK = 16


def reference_logits(model: reference.Model, pool, mel_length: int, picks: list,
                     device) -> tuple:
    """The reference's logits ``[n, G, V]`` at the positions that predicted
    each picked request's served tokens (EOS masked), and the tokens
    ``[n, G]``.  ``picks``: (pool index, served tokens)."""
    idx = [int(p) for p, _ in picks]
    served = torch.as_tensor(np.stack([np.asarray(t) for _, t in picks]), dtype=torch.long,
                             device=device)
    pcm = torch.as_tensor(pool.pcm[idx], device=device).float() / 32768.0
    feats = reference.log_mel(pcm, model.cfg["encoder"]["num_mel_bins"])
    frames = torch.as_tensor(pool.mel_frames[idx], device=device)
    audio = model.project(model.encode(feats, frames))
    stride = model.cfg["projector_pool_stride"]
    n_audio = reference.audio_tokens(reference.conv_len(mel_length), stride)
    prompt = reference.chat(model.cfg["system_prompt"], reference.user_turn(n_audio), None)
    ids = torch.cat([torch.as_tensor(prompt, device=device).expand(len(idx), -1),
                     served[:, :-1]], dim=1)
    logits = model.decode(model.splice(ids, audio), torch.ones_like(ids), last=len(prompt) - 1)
    logits[..., list(reference.EOS_IDS)] = float("-inf")
    return logits, served


def served_gaps(cfg: dict, seed: int, device, pool, mel_length: int, picks: list,
                prec: reference.Precision = reference.FP32) -> dict:
    """Over the picked requests: ``widest_gap``, the widest gap of a served
    token below the fp32 reference's best logit, and ``flip_share``, the
    share of served tokens that are not the reference's best.  With ``prec``
    fp8 they are read of the token the fp8 reference puts first at each
    position instead (the control).  ``BLOCK`` requests at a time."""
    reference.no_tf32()
    ref = reference.Model(cfg, weights.make_params(cfg, seed, device, dtype_of(cfg)))
    widest, flips, tokens = 0.0, 0, 0
    with torch.no_grad():
        for s in range(0, len(picks), BLOCK):
            block = picks[s:s + BLOCK]
            ref.prec = reference.FP32
            logits, served = reference_logits(ref, pool, mel_length, block, device)
            if prec.kind != "fp32":
                ref.prec = prec
                served = reference_logits(ref, pool, mel_length, block, device)[0].argmax(dim=-1)
            best = logits.max(dim=-1).values
            gap = best - logits.gather(-1, served[..., None])[..., 0]
            widest = max(widest, float(gap.max()))
            flips += int((gap > 0).sum())
            tokens += gap.numel()
    return {"widest_gap": widest, "flip_share": flips / tokens}
