"""WAV read/write with pure-Python resampling (the port's own copy of
`zeggs_tpu/io/wav.py`, numpy and scipy only).

Replaces the reference's sox/ffmpeg binary dependency
(ZEGGS/audio/audio_files.py:88-163 probes sox and shells out on format
mismatch) with `scipy.signal.resample_poly` — no external binaries.

Rescale semantics follow audio_files.py:211-236: int16/32768, int32/2^31,
uint8 offset-binary, floats asserted in [-1, 1].
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def _rescale_to_float32(x):
    if x.dtype == np.int16:
        return (x / 32768.0).astype(np.float32)
    if x.dtype == np.int32:
        return (x / 2147483648.0).astype(np.float32)
    if x.dtype in (np.float32, np.float64):
        if np.max(np.abs(x)) > 1.0:
            raise ValueError("float wav contains samples outside [-1, 1]")
        return x.astype(np.float32)
    if x.dtype == np.uint8:
        return (((x / 255.0) - 0.5) * 2.0).astype(np.float32)
    raise TypeError(f"unsupported wav sample type {x.dtype}")


def read_wavfile(
    file_path,
    rescale=True,
    desired_fs=None,
    desired_nb_channels=None,
    out_type="float32",
    logger=None,
):
    """Read a WAV file -> (fs, samples float32 in [-1, 1]).

    On sample-rate mismatch the audio is polyphase-resampled in-process;
    multi-channel audio is averaged to mono when desired_nb_channels == 1
    (or always when a channel count of 1 is implied by downstream use).
    """
    fs, x = wavfile.read(str(file_path))
    if rescale:
        x = _rescale_to_float32(x)
    else:
        x = np.asarray(x).astype(out_type)

    if x.ndim == 2:
        if desired_nb_channels in (None, 1):
            x = x.mean(axis=1).astype(np.float32)
        elif x.shape[1] != desired_nb_channels:
            raise ValueError(f"wav has {x.shape[1]} channels, wanted {desired_nb_channels}")

    if desired_fs is not None and fs != desired_fs:
        g = np.gcd(int(fs), int(desired_fs))
        x = resample_poly(x, desired_fs // g, fs // g).astype(np.float32)
        fs = desired_fs
    return fs, x


def write_wavefile(file_path, pcm_data, sampling_rate, out_type="int16"):
    """Write samples; floats in [-1, 1] scale to int16 by 2**15
    (audio_files.py:166-181)."""
    data = np.asarray(pcm_data)
    if data.dtype.kind == "f" and out_type == "int16":
        data = data * 2**15
    wavfile.write(str(file_path), sampling_rate, data.astype(out_type))


def trim_silence(
    x, fs, silence_threshold=0.1, min_silence_duration=0.01, buffer_around_silence=True
):
    """Trim leading/trailing silence from float samples.

    In-process equivalent of the sox ``silence`` effect pair the reference
    applies (audio_files.py:60-67: location=1 then location=-1,
    buffer_around_silence=True). ``silence_threshold`` is a PERCENTAGE of
    full scale (sox semantics: 0.1 -> 0.1% ~= -60 dBFS). A sample anchors
    the trim boundary only when it is above threshold AND at least 1/8 of
    the surrounding ``min_silence_duration`` window is too — an isolated
    click inside the silence does not count as sound, while real audio
    (which dips through zero crossings, so strict sample contiguity would
    never hold) does. If NO sample meets the density quorum (clip shorter
    than the window, or transient-only audio), plain above-threshold
    samples anchor the boundaries instead of returning empty. With ``buffer_around_silence`` one
    ``min_silence_duration`` of the removed silence is kept adjacent to
    the audio. Multi-channel input is trimmed on the per-frame max
    amplitude across channels (all channels keep the same length).
    """
    x = np.asarray(x)
    thresh = (silence_threshold / 100.0) * 1.0  # float full scale == 1.0
    amp = np.abs(x)
    if amp.ndim > 1:
        amp = amp.max(axis=tuple(range(1, amp.ndim)))
    loud = amp >= thresh
    run = max(1, int(round(min_silence_duration * fs)))
    # convolve(mode="same") returns length max(len, window): clamp the
    # density window to the clip so short clips don't shape-mismatch
    win = min(run, len(loud)) if len(loud) else 1
    if win > 1:
        near = np.convolve(loud.astype(np.int32), np.ones(win, np.int32), mode="same")
        dense = loud & (near >= max(1, win // 8))
    else:
        dense = loud
    if not dense.any():
        # a transient shorter than the density quorum is still sound —
        # fall back to plain loud-sample anchoring rather than returning
        # an empty clip for legitimate (if tiny) audio
        dense = loud
    if not dense.any():
        return x[:0]
    first, last = int(np.argmax(dense)), int(len(dense) - 1 - np.argmax(dense[::-1]))
    buf = run if buffer_around_silence else 0
    start = max(0, first - buf)
    end = min(len(x), last + 1 + buf)
    return x[start:end]


def reformat_and_trim_wav_file(
    wav_file,
    fs,
    bit_depth,
    nb_channels,
    overwrite=True,
    out_path=None,
    silence_threshold=0.1,
    min_silence_duration=0.01,
    silence_pad=True,
    logger=None,
):
    """Re-format a WAV file in-process: trim head/tail silence, resample to
    ``fs``, convert channels/bit depth, pad 0.01 s of silence at both ends.

    Same surface and defaults as the reference's sox-based
    ``reformat_and_trim_wav_file`` (audio_files.py:10-85) with NO external
    binary: overwrite=True replaces the input atomically via a _tmp file;
    otherwise the result lands in ``out_path`` or a ``processed_<fs>/``
    sibling directory, exactly like the reference's path handling.
    Returns the path written.
    """
    import os

    initial_path = os.path.normpath(str(wav_file)).strip()
    if overwrite:
        # splitext, not str.replace: a name without a literal ".wav"
        # substring (e.g. clip.WAV) must still get a DISTINCT tmp path,
        # or the remove+rename below would delete the fresh output
        root, ext = os.path.splitext(os.path.basename(initial_path))
        dest = os.path.join(os.path.dirname(initial_path), f"{root}_tmp{ext or '.wav'}")
    elif out_path:
        dest = os.path.normpath(str(out_path)).strip()
    else:
        d = os.path.join(os.path.dirname(initial_path), f"processed_{fs}")
        os.makedirs(d, exist_ok=True)
        dest = os.path.join(d, os.path.basename(initial_path))

    in_fs, x = read_wavfile(
        initial_path, rescale=True, desired_fs=None,
        desired_nb_channels=None if nb_channels == 1 else nb_channels,
    )
    if silence_threshold > 0.0:
        x = trim_silence(x, in_fs, silence_threshold, min_silence_duration)
    if in_fs != fs:
        g = np.gcd(int(in_fs), int(fs))
        x = resample_poly(x, fs // g, in_fs // g).astype(np.float32)
    if nb_channels > 1 and x.ndim == 1:
        x = np.repeat(x[:, None], nb_channels, axis=1)
    if silence_pad:
        pad = np.zeros((int(round(0.01 * fs)),) + x.shape[1:], np.float32)
        x = np.concatenate([pad, x, pad], axis=0)

    out_type = {16: "int16", 32: "int32"}.get(int(bit_depth))
    if out_type is None:
        raise ValueError(f"unsupported bit depth {bit_depth} (16 or 32)")
    data = np.clip(x, -1.0, 1.0) * (2 ** (int(bit_depth) - 1) - 1)
    wavfile.write(dest, fs, data.astype(out_type))

    if overwrite:
        os.remove(initial_path)
        os.rename(dest, initial_path)
        return initial_path
    return dest
