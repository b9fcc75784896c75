"""The plain reference: the model written out in fp32 PyTorch.

It imports nothing of the program and nothing of JAX.  From the benchmark's
own inputs (PCM, transcripts, the seeded weights of ``weights.py``) it works
out again everything the program derives: the prompt's token ids (a byte
tokenizer with the Qwen3 chat template), the bucketed padding, the log-mel
features, the encoder, the MLP projector, the splice of the audio
embeddings into the prompt, the Qwen3 decoder and the loss.

Departures from the program, each on purpose: every product and every
softmax is fp32 (the program: bf16 operands, an int8 KV cache), TF32 is off,
and the encoder's GELU is the exact erf form (the program takes the tanh
form in bf16).

:class:`Precision` sets how products are taken: ``"fp32"`` for the
reference, ``"fp8"`` for the control, the usual fp8 recipe (one scale a
tensor): both operands of every product, attention's included, rounded to
e4m3 before an fp32 product, and the gradient flowing into a product
rounded to e5m2.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
MEL_BUCKETS = (500, 1000, 1500, 2000, 2500, 3000)
PROMPT = "Transcribe the speech to text"
# the byte tokenizer: ids 0..255 are bytes, then these specials in order
SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<think>", "</think>", "<audio>")
SPECIAL_ID = {s: 256 + i for i, s in enumerate(SPECIALS)}
AUDIO_ID = SPECIAL_ID["<audio>"]
PAD_ID = SPECIAL_ID["<|endoftext|>"]
EOS_IDS = (SPECIAL_ID["<|im_end|>"], SPECIAL_ID["<|endoftext|>"])


def no_tf32() -> None:
    """Full fp32 products on the card, for the rest of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def round_f8(x: torch.Tensor, dtype=torch.float8_e4m3fn, fmax: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale for the whole tensor."""
    scale = x.abs().amax().clamp(min=1e-30) / fmax
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to e4m3 and, in the backward, the
    incoming gradient rounded to e5m2 (each under one scale a tensor)."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = round_f8(a), round_f8(b)
        ctx.save_for_backward(aq, bq)
        ctx.shapes = (a.shape, b.shape)
        return aq @ bq

    @staticmethod
    def backward(ctx, grad):
        aq, bq = ctx.saved_tensors
        gq = round_f8(grad, torch.float8_e5m2, E5M2_MAX)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (gq @ bq.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        if ctx.needs_input_grad[1]:
            db = (aq.transpose(-1, -2) @ gq).sum_to_size(ctx.shapes[1])
        return da, db


class Precision:
    """How products are taken: ``"fp32"`` as they are, ``"fp8"`` with the
    operands rounded (:class:`_Fp8Matmul`)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product taken outside :meth:`mm` (the convolutions)."""
        return x.float() if self.kind == "fp32" else round_f8(x.float())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        return a @ b if self.kind == "fp32" else _Fp8Matmul.apply(a, b)


FP32 = Precision("fp32")


# ----------------------------------------------------------------- tokens

def encode_text(text: str) -> list[int]:
    """Bytes and specials as ids."""
    ids: list[int] = []
    i = 0
    while i < len(text):
        for s in SPECIALS:
            if text.startswith(s, i):
                ids.append(SPECIAL_ID[s])
                i += len(s)
                break
        else:
            j = i + 1
            while j < len(text) and text[j] != "<":
                j += 1
            ids.extend(text[i:j].encode("utf-8"))
            i = j
    return ids


def chat(system: Optional[str], user: str, answer: Optional[str]) -> list[int]:
    """The Qwen3 chat template with thinking off; without ``answer`` it ends
    with the generation prompt."""
    text = f"<|im_start|>system\n{system}<|im_end|>\n" if system else ""
    text += f"<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n<think>\n\n</think>\n\n"
    if answer is not None:
        text += f"{answer}<|im_end|>\n"
    return encode_text(text)


def user_turn(n_audio: int) -> str:
    return "<audio>" * n_audio + " " + PROMPT


# ----------------------------------------------------------------- audio

def bucket_frames(n: int) -> int:
    for b in MEL_BUCKETS:
        if n <= b:
            return b
    step = MEL_BUCKETS[-1] - MEL_BUCKETS[-2]
    return MEL_BUCKETS[-1] + math.ceil((n - MEL_BUCKETS[-1]) / step) * step


def conv_len(n):
    """Encoder frames for ``n`` mel frames: conv k3 s1 p1 keeps ``n``, then
    k3 s2 p1 halves it, rounding up."""
    return (n - 1) // 2 + 1


def audio_tokens(enc_frames, stride: int):
    return (enc_frames - stride) // stride + 1


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular filters ``[201, n_mels]``."""
    def to_mel(hz):
        hz = np.asarray(hz, np.float64)
        return np.where(hz >= 1000.0, 15.0 + np.log(np.maximum(hz, 1000.0) / 1000.0) * 27.0
                        / np.log(6.4), 3.0 * hz / 200.0)

    def to_hz(mel):
        mel = np.asarray(mel, np.float64)
        return np.where(mel >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (mel - 15.0)),
                        200.0 * mel / 3.0)

    edges = to_hz(np.linspace(to_mel(0.0), to_mel(8000.0), n_mels + 2))
    freqs = np.linspace(0, SAMPLE_RATE // 2, N_FFT // 2 + 1)
    lower = (freqs[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])[None, :]
    upper = (edges[None, 2:] - freqs[:, None]) / (edges[2:] - edges[1:-1])[None, :]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return fb * (2.0 / (edges[2:] - edges[:-2]))[None, :]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Whisper's log-mel ``[B, n_mels, N // hop]`` of fp32 audio ``[B, N]``
    (centred reflect-padded STFT, periodic Hann, the last frame dropped)."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=audio.device)
    spec = torch.stft(audio.double(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)[..., :-1]
    power = spec.abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)
    logs = torch.log10(mel.clamp(min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((logs + 4.0) / 4.0).float()


# ----------------------------------------------------------------- towers

def layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["weight"].float(), p["bias"].float(), eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def attend(q, k, v, mask, prec: Precision):
    """Softmax attention in fp32: q ``[B, Hq, Tq, D]``, k/v ``[B, Hkv, Tk, D]``
    (GQA: query head h reads key head h // (Hq / Hkv)); ``mask`` broadcasts to
    ``[B, 1, Tq, Tk]`` (True: attend)."""
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask, float("-inf"))
    return prec.mm(torch.softmax(s, dim=-1), v)


class Model:
    """The reference model over a weights tree (``weights.make_params``) and
    a configuration file's dict; every weight is taken to fp32 once."""

    def __init__(self, cfg: dict, tree: dict, prec: Precision = FP32):
        self.cfg, self.prec = cfg, prec
        w = torch.Tensor.float
        enc, proj, dec = tree["encoder"], tree["projector"], tree["decoder"]
        self.enc = {
            "conv1": (w(enc["conv1"]["kernel"]), enc["conv1"]["bias"].float()),
            "conv2": (w(enc["conv2"]["kernel"]), enc["conv2"]["bias"].float()),
            "pos": enc["embed_positions"].float(),
            "final": enc["layer_norm"],
        }
        el = enc["layers"]
        self.enc_layers = [
            {"ln1": {k: v[i] for k, v in el["self_attn_layer_norm"].items()},
             "ln2": {k: v[i] for k, v in el["final_layer_norm"].items()},
             **{n: (w(el[n]["kernel"][i]), el[n]["bias"][i].float() if "bias" in el[n] else None)
                for n in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")}}
            for i in range(cfg["encoder"]["num_layers"])]
        self.proj = {"linear_1": proj["linear_1"]["kernel"], "norm": proj["norm"]["weight"],
                     "linear_2": proj["linear_2"]["kernel"], "norm_2": proj["norm_2"]["weight"]}
        self.embed = dec["embed_tokens"]["embedding"].float()
        self.head = w(self.embed.T)
        dl = dec["layers"]
        self.dec_layers = [
            {"ln1": dl["input_layernorm"]["weight"][i].float(),
             "ln2": dl["post_attention_layernorm"]["weight"][i].float(),
             "q_norm": dl["q_norm"][i].float(), "k_norm": dl["k_norm"][i].float(),
             **{n: w(dl[n]["kernel"][i]) for n in
                ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")}}
            for i in range(cfg["decoder"]["num_layers"])]
        self.final_norm = dec["norm"]["weight"].float()

    # ------------------------------------------------------------- encoder

    def conv(self, x, name, stride):
        kernel, bias = self.enc[name]  # [k, in, out]
        return F.conv1d(self.prec.round(x), self.prec.round(kernel).permute(2, 1, 0), bias,
                        stride=stride, padding=1)

    def encode(self, feats: torch.Tensor, mel_frames: torch.Tensor) -> torch.Tensor:
        """``[B, n_mels, T]`` features and each row's real mel frames ->
        ``[B, T_enc, d]`` (keys past a row's encoder length masked)."""
        cfg, prec = self.cfg["encoder"], self.prec
        x = F.gelu(self.conv(feats.float(), "conv1", 1))
        x = F.gelu(self.conv(x, "conv2", 2)).transpose(1, 2)
        b, t, d = x.shape
        x = x + self.enc["pos"][:t]
        keys = torch.arange(t, device=x.device)[None, :] < conv_len(mel_frames)[:, None]
        mask = keys[:, None, None, :]
        h, hd = cfg["num_heads"], d // cfg["num_heads"]
        eps = cfg.get("layer_norm_eps", 1e-5)

        def lin(y, p):
            kernel, bias = p
            out = prec.mm(y, kernel)
            return out if bias is None else out + bias

        for p in self.enc_layers:
            y = layer_norm(x, p["ln1"], eps)
            q, k, v = (lin(y, p[n]).view(b, t, h, hd).transpose(1, 2)
                       for n in ("q_proj", "k_proj", "v_proj"))
            a = attend(q, k, v, mask, prec).transpose(1, 2).reshape(b, t, d)
            x = x + lin(a, p["out_proj"])
            y = layer_norm(x, p["ln2"], eps)
            x = x + lin(F.gelu(lin(y, p["fc1"])), p["fc2"])
        return layer_norm(x, self.enc["final"], eps)

    def project(self, hidden: torch.Tensor, proj: Optional[dict] = None) -> torch.Tensor:
        """The MLP projector: stack ``stride`` frames, linear, RMSNorm, GELU,
        linear, RMSNorm.  ``proj``: its weights (default the tree's; training
        passes fp32 leaves that take gradients)."""
        p = self.proj if proj is None else proj
        k = self.cfg["projector_pool_stride"]
        b, t, d = hidden.shape
        n = (t - k) // k + 1
        x = hidden[:, :n * k].reshape(b, n, d * k)
        x = self.prec.mm(x, p["linear_1"])
        x = F.gelu(rms_norm(x, p["norm"], 1e-6))
        x = self.prec.mm(x, p["linear_2"])
        return rms_norm(x, p["norm_2"], 1e-6)

    # ------------------------------------------------------------- decoder

    def decode(self, embeds: torch.Tensor, valid: torch.Tensor,
               last: Optional[int] = None) -> torch.Tensor:
        """Causal forward of ``[B, T, H]`` embeddings; ``valid [B, T]`` marks
        real positions (right padding: positions count the valid ones, keys
        past them are masked).  Returns fp32 logits ``[B, T, V]``, or of the
        positions from ``last`` on."""
        cfg, prec = self.cfg["decoder"], self.prec
        b, t, _ = embeds.shape
        nq, nkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        eps = cfg["rms_norm_eps"]
        pos = (valid.long().cumsum(dim=1) - 1).clamp(min=0).double()
        inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                         device=embeds.device) / hd))
        ang = pos[..., None] * inv
        cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]

        def rope(x):
            x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
            return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

        causal = torch.ones(t, t, dtype=torch.bool, device=embeds.device).tril()
        mask = causal[None, None] & valid.bool()[:, None, None, :]
        x = embeds.float()
        for p in self.dec_layers:
            y = rms_norm(x, p["ln1"], eps)
            q = prec.mm(y, p["q_proj"]).view(b, t, nq, hd)
            k = prec.mm(y, p["k_proj"]).view(b, t, nkv, hd)
            v = prec.mm(y, p["v_proj"]).view(b, t, nkv, hd)
            q = rope(rms_norm(q, p["q_norm"], eps).transpose(1, 2))
            k = rope(rms_norm(k, p["k_norm"], eps).transpose(1, 2))
            a = attend(q, k, v.transpose(1, 2), mask, prec)
            x = x + prec.mm(a.transpose(1, 2).reshape(b, t, nq * hd), p["o_proj"])
            y = rms_norm(x, p["ln2"], eps)
            g = F.silu(prec.mm(y, p["gate_proj"])) * prec.mm(y, p["up_proj"])
            x = x + prec.mm(g, p["down_proj"])
        if last is not None:
            x = x[:, last:]
        return prec.mm(rms_norm(x, self.final_norm, eps), self.head)

    def splice(self, ids: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Token embeddings with the j-th ``<audio>`` position of each row
        taking that row's j-th audio embedding."""
        x = self.embed[ids]
        is_audio = ids == AUDIO_ID
        j = (is_audio.long().cumsum(dim=1) - 1).clamp(min=0, max=audio.shape[1] - 1)
        picked = torch.gather(audio, 1, j[..., None].expand(-1, -1, audio.shape[-1]))
        return torch.where(is_audio[..., None], picked, x)
