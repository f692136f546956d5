"""Minimal dependency-free WAV I/O, a copy of ``avr_tpu/data/wav.py`` (the
reference leans on librosa; RAF stores per-sample ``rir.wav`` files —
reference/datasets_loader.py:164-166). Handles PCM 16/24/32-bit and
IEEE-float 32/64 mono/multichannel; reads return float32 in [−1, 1] with
shape [n_samples] (mono) or [n_samples, n_channels]."""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str, mono: bool = True):
    """Returns (samples float32, sample_rate int)."""
    with open(path, "rb") as f:
        riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            payload = f.read(chunk_size)
            if chunk_size % 2:
                f.read(1)  # chunks are word-aligned
            if chunk_id == b"fmt ":
                fmt = payload
            elif chunk_id == b"data":
                data = payload
                if fmt is not None:
                    break
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as32 = (as32 << 8) >> 8  # sign-extend
            x = as32.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}")

    if n_channels > 1:
        x = x.reshape(-1, n_channels)
        if mono:
            x = x.mean(axis=-1)
    return x, sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write float32 samples in [−1,1] as IEEE-float WAV."""
    x = np.asarray(samples, np.float32)
    n_channels = 1 if x.ndim == 1 else x.shape[1]
    payload = x.astype("<f4").tobytes()
    with open(path, "wb") as f:
        byte_rate = sample_rate * n_channels * 4
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(
            b"fmt " + struct.pack("<IHHIIHH", 16, 3, n_channels, sample_rate, byte_rate, n_channels * 4, 32)
        )
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)
