"""Streaming gesture synthesis: push audio chunks, pull gesture frames
(counterpart of `zeggs_tpu/infer/streaming.py`).

The decoder is recurrent, so its carry (GRU hidden states, integrated root
transform, previous pose) is kept on the device between pushes. A
`StreamingSession` fed any split of the audio emits the frames the offline
`generate_gesture` gives for the whole clip (same STFT reflect padding at
the head and tail, same mel -> 60 fps resample clipping, same k=31 conv
replicate lookahead, same decoder step), up to float reassociation.

Stages, each with its own lookahead:

  raw 16 kHz samples
    -> pre-emphasis (1-sample history; off by default, as the reference)
    -> STFT frames (need n_fft/2 = 400 future samples; head and tail
       padding applied once, at the start and in finish())
    -> mel rows at 80 Hz: the mel kernel (`ops/kernels/mel.py`) on each
       ready window, then 10**(db/20), ln and the row norm on the device
    -> linear resample onto the 60 fps grid (1 future mel row), on the host
    -> normalised audio features
    -> speech encoder (k=31 conv: 15 future frames), a valid convolution
       over the index-clamped window
    -> decoder chunks through the pipeline's program cache
       (`infer/programs.py`, shared by its sessions as `zeggs_tpu` shares
       ``pipe._stream_fn_cache``): CUDA graphs of the decoder step on a
       card, GRU1 of every step on the GRU-cell kernel
    -> gesture frames (root_pos, root_rot, lpos, ltxy)

The bucket ladders, grains and ``quantum`` of the JAX session are kept, so
a push emits as many frames as the JAX session's does. At finish() a
decoder tail shorter than the grain is padded to the grain with zero
speech rows and sliced, as the JAX session does: the step is causal, so
the padded steps change only the frames that are dropped and the carry,
which is dead after finish(), and a quantum-16 session runs one program.

Loudness normalisation (BS.1770) is a global transform and cannot be
streamed exactly; a session takes a fixed ``gain`` instead.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as TF

from ..data import features as F
from ..io import bvh as bvh_io
from ..models import decoder
from ..models import layers as L
from ..ops import quat, xform
from ..ops.kernels import mel as mel_kernel

_MEL_BUCKETS = (512, 128, 32, 8, 2, 1)
_SPEECH_BUCKETS = (256, 64, 16, 4, 1)
_DECODER_BUCKETS = (256, 64, 16, 4, 1)
_STATE0 = ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")
_KEYS = ("root_pos", "root_rot", "lpos", "ltxy")


def _largest_bucket(buckets, avail):
    for b in buckets:
        if b <= avail:
            return b
    return 0


class _MelStream:
    """Incremental log-mel and energy rows, as `ops.mel.audio_features`
    computes them before resampling.

    Keeps the reflect-padded, pre-emphasised sample stream on the host and
    emits (log_mel (n, n_mels), energy (n,)) rows as samples arrive.
    """

    def __init__(self, cfg, device, gain=1.0, grain=1):
        if not cfg.centered:
            raise ValueError("streaming mel requires the reference's centered STFT")
        # total_frames() reproduces the offline drop-a-frame condition
        # ((max(N, nfft) + nfft) % hop == 0) as max(N, nfft) % hop == 0,
        # which holds only when nfft is a multiple of the hop
        if cfg.filter_length % cfg.hop_length:
            raise ValueError("streaming mel requires filter_length % hop_length == 0 "
                             f"(got {cfg.filter_length} % {cfg.hop_length})")
        self.cfg = cfg
        self.device = device
        self.gain = float(gain)
        self.nfft = cfg.filter_length
        self.hop = cfg.hop_length
        # grain > 1 (batched mode): mid-stream, consume only buckets of at
        # least ``grain`` rows; the remainder waits for the next push
        self.grain = int(grain)
        self._head = np.zeros(0, np.float32)  # emphasised samples before the start
        self._ext = None  # reflect-headed emphasised stream, next frame at [0]
        self._tail = np.zeros(0, np.float32)  # last <= nfft+1 emphasised samples
        self._prev_raw = None  # last raw sample (pre-emphasis continuation)
        self.n_samples = 0  # raw samples pushed
        self.done = 0  # mel frames emitted
        self.finished = False

    def _rows(self, x, nf):
        """nf mel rows of the window x ((nf-1)*hop + nfft samples)."""
        db = mel_kernel.mel_frames(torch.as_tensor(x, device=self.device), nf, self.cfg)
        lin = 10.0 ** (db / 20.0)
        return torch.log(lin).cpu().numpy(), torch.linalg.norm(lin, dim=-1).cpu().numpy()

    # -- stream plumbing ----------------------------------------------------

    def _emphasize(self, raw):
        if not self.cfg.pre_emphasis:
            return raw
        prev = self._prev_raw
        self._prev_raw = raw[-1]
        if prev is None:  # y[0] = x[0]
            return np.concatenate([raw[:1], raw[1:] - self.cfg.pre_emph_coeff * raw[:-1]])
        shifted = np.concatenate([[prev], raw[:-1]])
        return raw - self.cfg.pre_emph_coeff * shifted

    def _append(self, emph):
        self._tail = np.concatenate([self._tail, emph])[-(self.nfft + 1):]
        half = self.nfft // 2
        if self._ext is None:
            self._head = np.concatenate([self._head, emph])
            if len(self._head) >= half + 1:
                # np.pad(x, (half, .), 'reflect') head = x[half:0:-1]
                self._ext = np.concatenate([self._head[half:0:-1], self._head])
                self._head = np.zeros(0, np.float32)
        else:
            self._ext = np.concatenate([self._ext, emph])

    def _consume(self, cap=None):
        """Emit frames from the ready window; ``cap`` bounds the total
        frames and is passed only by finish(), where it doubles as the flush
        flag."""
        outs = []
        flush = cap is not None
        while self._ext is not None:
            avail = (len(self._ext) - self.nfft) // self.hop + 1 if len(self._ext) >= self.nfft else 0
            if flush:
                avail = min(avail, cap - self.done)
            if flush and 0 < avail < self.grain:
                nf = avail
            else:
                nf = _largest_bucket(_MEL_BUCKETS, avail)
                if nf == 0 or (not flush and nf < self.grain):
                    break
            w = (nf - 1) * self.hop + self.nfft
            outs.append(self._rows(self._ext[:w], nf))
            self._ext = self._ext[nf * self.hop:]
            self.done += nf
        if not outs:
            return np.zeros((0, self.cfg.n_mel_channels), np.float32), np.zeros(0, np.float32)
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    # -- public ---------------------------------------------------------------

    def push(self, raw):
        raw = np.asarray(raw, np.float32)
        if self.gain != 1.0:
            raw = raw * np.float32(self.gain)
        self.n_samples += len(raw)
        if len(raw):
            self._append(self._emphasize(raw))
        return self._consume()

    def total_frames(self):
        """The offline frame count (`ops.mel.num_frames`): padded length
        n = max(N, n_fft) + n_fft; (n - n_fft)/hop frames when that divides
        exactly (the +1 frame is dropped), else 1 + floor((n - n_fft)/hop)."""
        n_pad = max(self.n_samples, self.nfft)
        return n_pad // self.hop if n_pad % self.hop == 0 else n_pad // self.hop + 1

    def finish(self):
        assert not self.finished
        self.finished = True
        half = self.nfft // 2
        # the zero padding to n_fft of short signals (ops.mel.mel_spectrogram_tts)
        pad0 = max(0, self.nfft - self.n_samples)
        if pad0:
            self._append(np.zeros(pad0, np.float32))
        # reflect tail: np.pad right pad = x[-2 : -half-2 : -1]
        self._append(self._tail[-2 : -half - 2 : -1])
        return self._consume(cap=self.total_frames())


class _Resampler:
    """Mel-rate rows -> 60 fps feature rows with `ops.mel.audio_features`'
    resampling: the mel channels clipped to the hull, the energy
    extrapolated; then the audio statistics' normalisation."""

    def __init__(self, cfg, anim_fs, feature_type, stats_mean, stats_std):
        self.step = np.float32((cfg.sampling_rate / cfg.hop_length) / anim_fs)
        self.feature_type = feature_type
        self.mean = np.asarray(stats_mean, np.float32)
        self.std = np.asarray(stats_std, np.float32)
        self.log_mel = np.zeros((0, cfg.n_mel_channels), np.float32)
        self.energy = np.zeros(0, np.float32)
        self.done = 0  # feature rows emitted

    def _rows(self, i_lo, i_hi, t_mel_final=None):
        t = self.step * np.arange(i_lo, i_hi).astype(np.float32)
        T = len(self.log_mel) if t_mel_final is None else t_mel_final
        feats = []
        if "mel_spec" in self.feature_type:
            tm = np.clip(t, 0.0, np.float32(T - 1.0))
            i0 = np.clip(np.floor(tm).astype(np.int32), 0, T - 2)
            frac = (tm - i0)[:, None]
            feats.append(self.log_mel[i0] * (np.float32(1.0) - frac) + self.log_mel[i0 + 1] * frac)
        if "energy" in self.feature_type:
            i0 = np.clip(np.floor(t).astype(np.int32), 0, T - 2)
            frac = (t - i0)[:, None]
            e = self.energy[:, None]
            feats.append(e[i0] * (np.float32(1.0) - frac) + e[i0 + 1] * frac)
        raw = np.concatenate(feats, axis=-1)  # float64: frac mixes float32 and int32
        return ((raw - self.mean) / self.std).astype(np.float32)

    def push(self, log_mel, energy):
        """The normalised feature rows that are safe to emit, (n, n_features).

        Interior rows need mel rows floor(t) and floor(t)+1 with no end
        clipping: safe while floor(step*i) <= m-2, where the offline clip at
        T_final-2 >= m-2 changes nothing. The bound is evaluated in float32,
        the arithmetic `_rows` uses, so that a product landing on an integer
        cannot emit a row whose i0+1 does not exist yet."""
        if len(log_mel):
            self.log_mel = np.concatenate([self.log_mel, log_mel])
            self.energy = np.concatenate([self.energy, energy])
        m = len(self.log_mel)
        if m < 2:
            return np.zeros((0, self.mean.shape[-1]), np.float32)
        upper = int(m / float(self.step)) + 2
        t = self.step * np.arange(self.done, upper).astype(np.float32)
        ok = np.floor(t).astype(np.int64) <= m - 2
        hi = self.done + int(np.argmin(ok)) if not ok.all() else upper
        if hi <= self.done:
            return np.zeros((0, self.mean.shape[-1]), np.float32)
        rows = self._rows(self.done, hi)
        self.done = hi
        return rows

    def append_final(self, log_mel, energy):
        """Append the tail mel rows of `_MelStream.finish` without emitting
        interior rows (finish() resamples them with end clipping)."""
        if len(log_mel):
            self.log_mel = np.concatenate([self.log_mel, log_mel])
            self.energy = np.concatenate([self.energy, energy])

    def finish(self, n_frames, t_mel_final):
        """All remaining rows, with the offline end clipping."""
        if n_frames <= self.done:
            return np.zeros((0, self.mean.shape[-1]), np.float32)
        rows = self._rows(self.done, n_frames, t_mel_final=t_mel_final)
        self.done = n_frames
        return rows


class _SpeechStream:
    """Speech-encoder frames with the k=31 replicate-conv lookahead: frame i
    reads feature rows [i-15, i+15], clamped to the sequence ends."""

    LOOK = 15  # (31 - 1) / 2

    def __init__(self, encoder, device, grain=1):
        self.encoder = encoder
        self.device = device
        self.feats = None  # (n, F) normalised rows, host
        self.done = 0
        self.grain = int(grain)  # see _MelStream

    def _encode(self, x):
        """(n + 30, F) feature rows -> (n, S) encodings on the device."""
        enc = self.encoder
        h = torch.as_tensor(x, device=self.device).T[None]
        h = L.elu(TF.conv1d(h, enc.conv0.weight, enc.conv0.bias))  # k=1: no padding
        h = L.elu(TF.conv1d(h, enc.conv1.weight, enc.conv1.bias))  # valid, k=31
        return L.elu(L.linear(h.transpose(1, 2), enc.linear))[0]

    def _emit(self, hi, end_idx, flush=False):
        outs = []
        while self.done < hi:
            rem = hi - self.done
            if flush and rem < self.grain:
                n = rem
            else:
                n = _largest_bucket(_SPEECH_BUCKETS, rem)
                if n == 0 or (not flush and n < self.grain):
                    break
            idx = np.clip(np.arange(self.done - self.LOOK, self.done + n + self.LOOK), 0, end_idx)
            outs.append(self._encode(self.feats[idx]))
            self.done += n
        return torch.cat(outs) if outs else None

    def push(self, rows):
        self.feats = rows if self.feats is None else np.concatenate([self.feats, rows])
        # frame i needs rows through i+15 and must not touch the (unknown)
        # end clamp: safe while i + LOOK <= len-1
        hi = len(self.feats) - self.LOOK
        if hi <= self.done:
            return None
        return self._emit(hi, len(self.feats) + 10**9)  # no end clamp yet

    def finish(self, n_frames):
        assert self.feats is not None and len(self.feats) == n_frames
        if self.done >= n_frames:
            return None
        return self._emit(n_frames, n_frames - 1, flush=True)


class StreamingSession:
    """Incremental gesture synthesis against a loaded `GesturePipeline`.

    Usage:
        sess = pipe.streaming_session(styles=[(bvh, (0, 256))], first_pose=bvh)
        for chunk in audio_chunks:          # float32 at cfg.sampling_rate
            new = sess.push(chunk)          # dict of new frames (may be empty)
        tail = sess.finish()
        sess.write_bvh(out_dir, "clip")     # or use sess.result()

    Frames come out as numpy arrays keyed root_pos (n, 3), root_rot (n, 4),
    lpos (n, J, 3), ltxy (n, J, 2, 3); frame 0 (the first-pose state) is
    emitted at construction, as in the offline rollout.

    Against `generate_gesture`: style blending is "add" only ("stitch" needs
    the clip length up front). The style draws mirror `generate_gesture`'s:
    one `torch.Generator` seeded with ``seed``, one draw per example style
    in order, so a session equals the offline clip at any temperature.
    """

    @torch.inference_mode()
    def __init__(self, pipe, styles, first_pose=None, blend_ratio=(0.5, 0.5),
                 temperature=1.0, seed=1234, gain=1.0, quantum=1):
        """quantum: run no decoder chunk shorter than this mid-stream
        (finish() always flushes). At 16 or more (the serving default) the
        mel and speech stages consume in grains of 8 and 16 rows too: fewer,
        larger launches for a few frames more lag. Sessions run the
        'normal' decoder cell, as the reference's do."""
        if pipe.opts.net.decoder.rnn_cond != "normal":
            raise NotImplementedError("streaming supports the 'normal' decoder cell")
        self.pipe = pipe
        dev = pipe.device
        self.quantum = int(quantum)
        batched = self.quantum >= 16
        self._grain_dec = 16 if batched else 1
        self._mel = _MelStream(pipe.mel_cfg, dev, gain=gain, grain=8 if batched else 1)
        self._resample = _Resampler(
            pipe.mel_cfg, 60, pipe.audio_feature_type,
            pipe.stats["audio_input_mean"].cpu().numpy(),
            pipe.stats["audio_input_std"].cpu().numpy(),
        )
        self._speech = _SpeechStream(pipe.networks["speech_encoder"], dev,
                                     grain=16 if batched else 1)
        self.finished = False

        self.style, last_feats = self._resolve_styles(styles, blend_ratio, temperature, seed)

        if first_pose is None:
            feats0 = last_feats
            if feats0 is None:
                raise ValueError("no first pose available: give first_pose or a BVH style example")
        elif isinstance(first_pose, (str, Path)):
            feats0 = F.preprocess_animation(bvh_io.load(first_pose), device=dev)
        elif isinstance(first_pose, dict):
            feats0 = F.preprocess_animation(dict(first_pose), device=dev)
        else:
            feats0 = first_pose  # AnimFeatures

        self._gaze0 = feats0.gaze_pos[0][None]  # (1, 3)
        state0 = tuple(getattr(feats0, k)[0:1] for k in _STATE0)
        s = pipe.stats
        self._carry = decoder.init_carry(pipe.networks["decoder"], *state0, self._gaze0,
                                         self.style, s["anim_input_mean"], s["anim_input_std"])
        self._speech_rows = None  # (n, S) encodings on the device; row 0 unused
        self._steps_done = 0
        self.decoder_steps = 0  # steps run, padded tails included
        self._out = [{k: state0[i].cpu().numpy() for k, i in zip(_KEYS, (0, 1, 4, 5))}]
        self.frames_emitted = 1

    # -- style resolution (mirrors generate_gesture's draws) -----------------

    def _resolve_styles(self, styles, blend_ratio, temperature, seed):
        pipe = self.pipe
        dev = pipe.device
        if isinstance(styles, np.ndarray):
            arr = torch.as_tensor(styles, dtype=torch.float32, device=dev)
            return (arr if arr.ndim == 2 else arr[None]), None
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        encs, last_feats = [], None
        for style in styles:
            if pipe.style_encoding_type == "label":
                encs.append(pipe.label_encoding(style))
            elif isinstance(style, (tuple, list)) and isinstance(style[0], (str, Path)):
                vec, last_feats = pipe.style_example_from_bvh(style[0], style[1])
                encs.append(pipe.encode_style(vec, temperature, generator)[0])
            elif isinstance(style, np.ndarray):
                encs.append(torch.as_tensor(style, dtype=torch.float32, device=dev)[None])
            else:
                raise ValueError(f"bad style spec {style!r}")
        if len(encs) > 1:
            if len(encs) != len(blend_ratio):
                raise ValueError("add needs one blend ratio per style")
            ratio = torch.as_tensor(blend_ratio, dtype=torch.float32, device=dev)
            return torch.einsum("bnc,n->bc", torch.stack(encs, dim=1), ratio), last_feats
        return encs[0], last_feats

    # -- decoder chunks ------------------------------------------------------

    def _run_decoder(self, n, steps=None):
        """n decoder steps from the carry -> the 4 emitted (1, n, ...)
        tensors. ``steps`` > n pads the chunk with zero speech rows and runs
        that many steps (the finish tail)."""
        steps = steps or n
        lo = 1 + self._steps_done  # step t consumes speech row 1 + t
        speech = self._speech_rows[lo : lo + n]
        if steps > n:
            speech = torch.cat([speech, speech.new_zeros((steps - n, speech.shape[1]))])
        gaze = self._gaze0[:, None].expand(1, steps, 3)
        style = self.style[:, None].expand(1, steps, self.style.shape[-1])
        self._carry, out = self.pipe.programs.rollout_chunk(self._carry, gaze, speech[None], style,
                                                            slot="stream")
        self._steps_done += n
        self.decoder_steps += steps
        return tuple(o[:, :n] for o in out)

    def _advance_decoder(self, flush=False):
        if self._speech_rows is None:
            return
        emitted = []
        while True:
            avail = (self._speech_rows.shape[0] - 1) - self._steps_done
            if flush and 0 < avail < self._grain_dec:
                # pad the tail to the grain and slice it (JAX's pad-and-slice)
                emitted.append(self._run_decoder(avail, self._grain_dec))
                break
            n = _largest_bucket(_DECODER_BUCKETS, avail)
            if n == 0 or (not flush and n < self.quantum):
                break
            emitted.append(self._run_decoder(n))
        if emitted:
            entry = {k: torch.cat([o[i] for o in emitted], dim=1)[0].cpu().numpy()
                     for i, k in enumerate(_KEYS)}
            self._out.append(entry)
            self.frames_emitted += entry["root_pos"].shape[0]

    def _add_speech(self, enc):
        if enc is not None:
            self._speech_rows = enc if self._speech_rows is None else torch.cat(
                [self._speech_rows, enc])

    # -- public ---------------------------------------------------------------

    @property
    def samples_received(self):
        """Raw samples pushed so far (they set the offline frame count at
        finish, and let callers refuse to finish an empty stream)."""
        return self._mel.n_samples

    @torch.inference_mode()
    def push(self, audio_chunk):
        """Feed raw samples; returns the dict of new gesture frames."""
        assert not self.finished
        before = len(self._out)
        log_mel, energy = self._mel.push(audio_chunk)
        if len(log_mel):
            rows = self._resample.push(log_mel, energy)
            if len(rows):
                self._add_speech(self._speech.push(rows))
        self._advance_decoder()
        return self._collect(before)

    @torch.inference_mode()
    def finish(self):
        """Flush every lookahead; returns the last new frames."""
        assert not self.finished
        before = len(self._out)
        n_frames = int(round(60.0 * (self._mel.n_samples / self.pipe.mel_cfg.sampling_rate)))
        log_mel, energy = self._mel.finish()
        self._resample.append_final(log_mel, energy)
        rows = self._resample.finish(n_frames, self._mel.total_frames())
        if len(rows):
            self._add_speech(self._speech.push(rows))
        self._add_speech(self._speech.finish(n_frames))
        self._advance_decoder(flush=True)
        assert self.frames_emitted == n_frames, (
            f"emitted {self.frames_emitted} frames, offline would emit {n_frames}"
        )
        self.finished = True
        return self._collect(before)

    def _collect(self, before):
        """Concatenate the (n, ...) entries appended since ``before``."""
        frames = self._out[before:]
        if not frames:
            J = self.pipe.njoints
            tails = {"root_pos": (3,), "root_rot": (4,), "lpos": (J, 3), "ltxy": (J, 2, 3)}
            return {k: np.zeros((0,) + tails[k], np.float32) for k in _KEYS}
        return {k: np.concatenate([f[k] for f in frames]) for k in _KEYS}

    def result(self):
        """(root_pos, root_rot, lpos, lrot) trajectories (1, T, ...) on the
        pipeline's device, joint rotations as quaternions, as
        `GesturePipeline.rollout` returns them."""
        full = self._collect(0)
        root_pos, root_rot, lpos, ltxy = (torch.as_tensor(full[k], device=self.pipe.device)[None]
                                          for k in _KEYS)
        return root_pos, root_rot, lpos, quat.from_xform(xform.orthogonalize_from_xy(ltxy))

    def write_bvh(self, results_path, file_name, audio_file=None):
        assert self.finished, "call finish() first"
        return self.pipe.write_result(results_path, file_name, self.result(), audio_file)
