"""Player/decoder configuration.

One flat options object passed down the stack, mirroring the reference's
documented option names (jsmpeg's README.md, "Options") where they are
meaningful off-browser, plus the port's own: the device, the audio
synthesis mode and batch decoding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


def resolve_device(device, owner: str) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one.  None means 'cuda'; asking for CUDA where there is
    none raises, so no entry point quietly runs on the CPU."""
    if device is None:
        device = 'cuda'
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'{owner}: no CUDA device is available; pass '
                "{'device': 'cpu'} to run on the CPU")
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{owner}: device {device} requested but CUDA '
                           'is not available')
    return device


def device_name(device: torch.device) -> str:
    """The name a result is reported under: the card's, or the device's
    own ('cpu')."""
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return str(device)


@dataclass
class PlayerConfig:
    # reference-compatible options
    loop: bool = False
    autoplay: bool = False
    audio: bool = True
    video: bool = True
    poster: Optional[str] = None            # write first frame here (.ppm)
    streaming: bool = False                 # EVICT buffers, latest-wins decode
    max_audio_lag: float = 0.25             # maxAudioLag
    video_buffer_size: int = 512 * 1024     # videoBufferSize
    audio_buffer_size: int = 128 * 1024     # audioBufferSize
    chunk_size: int = 1024 * 1024           # progressive source chunk
    decode_first_frame: bool = True
    progressive: bool = True
    throttled: bool = True
    reconnect_interval: float = 5.0

    # callbacks (reference: onVideoDecode/onAudioDecode/onPlay/...)
    on_video_decode: Optional[Callable] = None
    on_audio_decode: Optional[Callable] = None
    on_play: Optional[Callable] = None
    on_pause: Optional[Callable] = None
    on_ended: Optional[Callable] = None
    on_stalled: Optional[Callable] = None
    on_source_established: Optional[Callable] = None
    on_source_completed: Optional[Callable] = None

    # the port's own
    # where both decoders run: None = 'cuda' (raises without a GPU);
    # 'cpu' runs the plain versions of the kernels
    device: Optional[str] = None
    # audio synthesis: 'exact' = bit-exact host path (C++/float64 DAG);
    # 'device' = float32 synthesis batched on the device -- within ~3e-5
    # absolute of exact on non-saturated content; it cannot reproduce the
    # reference's deliberate int32 accumulator wraparound on saturated
    # noise (bounded by tests/test_torch_mp2.py)
    audio_mode: str = 'exact'               # 'exact' | 'device'
    batch_gop: bool = True                  # batch frames through the kernels
    # decode_offline over a mesh of closed GOPs (parallel/mesh.py
    # resolve_mesh forms: 8, '4x2', 'auto', a Mesh; None = no mesh)
    mesh: Any = None

    @classmethod
    def from_options(cls, options: Optional[dict]) -> 'PlayerConfig':
        """Accept a reference-style camelCase options dict."""
        if options is None:
            return cls()
        if isinstance(options, cls):
            return options
        alias = {
            'maxAudioLag': 'max_audio_lag',
            'videoBufferSize': 'video_buffer_size',
            'audioBufferSize': 'audio_buffer_size',
            'chunkSize': 'chunk_size',
            'decodeFirstFrame': 'decode_first_frame',
            'reconnectInterval': 'reconnect_interval',
            'onVideoDecode': 'on_video_decode',
            'onAudioDecode': 'on_audio_decode',
            'onPlay': 'on_play',
            'onPause': 'on_pause',
            'onEnded': 'on_ended',
            'onStalled': 'on_stalled',
            'onSourceEstablished': 'on_source_established',
            'onSourceCompleted': 'on_source_completed',
            'audioMode': 'audio_mode',
            'batchGOP': 'batch_gop',
        }
        kw = {}
        for k, v in options.items():
            key = alias.get(k, k)
            if key in cls.__dataclass_fields__:
                kw[key] = v
        return cls(**kw)
