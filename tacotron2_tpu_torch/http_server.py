"""HTTP serving on the port, over the micro-batching synthesizer.

Counterpart of the JAX package's ``http_server.py``, stdlib only:

    POST /synthesize   {"text": "...",
                        "vocoder": "none"|"griffin_lim"|"hifigan"|"waveglow"}
      -> audio/wav, or application/json with the mel for "none". A neural
      vocoder must be the one the server was started with
      (--vocoder hifigan|waveglow --vocoder_checkpoint V.pt).

    POST /stream       {"text": "..."}
      -> chunked transfer: raw signed-16-bit little-endian PCM
      (audio/L16;rate=SR) when a HiFi-GAN vocoder is loaded, else
      newline-delimited JSON mel events (application/x-ndjson). The first
      bytes leave while the decoder is still running
      (``streaming.StreamingSynthesizer``).

    GET /healthz       -> {"status": "ok"}

Concurrent /synthesize requests are coalesced into batches by
``serve.BatchingSynthesizer``, whose one worker thread runs the encoder and
batched decoder-chunk kernels (rows 3 and 5 of the kernel table); the
threaded HTTP server maps one request per thread onto its futures. /stream
requests take a lock (one utterance at a time owns the single-utterance
chunk kernel, row 6, and the streamer's buffers) and run on one long-lived
thread, as the neural vocoder's calls do (``serve.VocoderRunner``): PyTorch
keeps cuDNN's execution plans per thread, and the handler's thread is new
for every request.

    python -m tacotron2_tpu_torch.http_server -c OUT --port 8080 \\
        [--vocoder hifigan|waveglow --vocoder_checkpoint V.pt] \\
        [--hparams ...] [--device cuda|cpu]

serves the latest ``checkpoint_<step>.pt`` in OUT, on the card unless
``--device cpu``, with PyTorch's default TF32 settings (cuDNN convolutions
in TF32, matmuls in full fp32).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.audio.stft import STFTConfig, griffin_lim
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.infer import mel_to_linear
from tacotron2_tpu_torch.models import tacotron2
from tacotron2_tpu_torch.serve import (BatchingSynthesizer, VocoderRunner,
                                       _as_model)
from tacotron2_tpu_torch.streaming import StreamingSynthesizer


def _pcm16(audio: np.ndarray) -> np.ndarray:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2")


class TTSRequestHandler(BaseHTTPRequestHandler):
    synthesizer: BatchingSynthesizer = None  # set by make_server
    config: Tacotron2Config = None
    device: torch.device = None
    vocoder_kind: str = "none"               # neural vocoder loaded, if any
    vocoder_runner: Optional[VocoderRunner] = None
    streamer: Optional[StreamingSynthesizer] = None
    stream_lock: threading.Lock = None
    stream_worker: ThreadPoolExecutor = None  # the streamer's one thread
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response's last short segment leaves at once, not
    # after the client's delayed ACK (~40 ms a response on Linux)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, {"status": "ok"})
        else:
            self._json(404, {"error": "not found"})

    def _wav(self, audio: np.ndarray) -> None:
        import scipy.io.wavfile
        buf = io.BytesIO()
        scipy.io.wavfile.write(buf, self.config.sampling_rate, _pcm16(audio))
        wav = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(wav)))
        self.end_headers()
        self.wfile.write(wav)

    def _read_payload(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _griffin_lim(self, mel: np.ndarray) -> np.ndarray:
        cfg = self.config
        mel_t = torch.as_tensor(mel, dtype=torch.float32,
                                device=self.device)[None]
        audio = griffin_lim(mel_to_linear(mel_t, cfg),
                            STFTConfig(cfg.filter_length, cfg.hop_length,
                                       cfg.win_length), n_iters=30)
        return audio[0].cpu().numpy()

    def do_POST(self):
        if self.path == "/stream":
            self._do_stream()
            return
        if self.path != "/synthesize":
            self._json(404, {"error": "not found"})
            return
        try:
            payload = self._read_payload()
            text = payload.get("text", "")
            if not text:
                self._json(400, {"error": "missing 'text'"})
                return
            vocoder = payload.get("vocoder", "none")
            if vocoder not in ("none", "griffin_lim", "hifigan", "waveglow"):
                self._json(400, {"error": f"unknown vocoder {vocoder!r}"})
                return
            if vocoder in ("hifigan", "waveglow") and \
                    vocoder != self.vocoder_kind:
                self._json(400, {"error":
                                 f"vocoder {vocoder!r} not loaded "
                                 f"(server has {self.vocoder_kind!r})"})
                return
            mel, _, n_frames = self.synthesizer.submit(text).result(
                timeout=float(payload.get("timeout_s", 300)))
            cfg = self.config
            if vocoder == "none":
                self._json(200, {
                    "n_frames": int(n_frames),
                    "audio_seconds": n_frames * cfg.hop_length
                    / cfg.sampling_rate,
                    "mel": mel.tolist(),
                })
            elif vocoder == "griffin_lim":
                self._wav(self._griffin_lim(mel))
            else:
                self._wav(self.vocoder_runner(mel))
        except Exception as e:  # robust endpoint: report, don't crash
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def _do_stream(self):
        """Chunked-transfer low-latency synthesis (see the module's
        docstring)."""
        try:
            payload = self._read_payload()
            text = payload.get("text", "")
            if not text:
                self._json(400, {"error": "missing 'text'"})
                return
        except Exception as e:
            self._json(400, {"error": f"{type(e).__name__}: {e}"})
            return

        audio_mode = self.streamer.vocoder is not None
        with self.stream_lock:
            events: "queue.Queue" = queue.Queue()

            def produce():  # on the streamer's thread; None ends the stream
                try:
                    for ev in self.streamer.stream(text):
                        events.put(ev)
                except Exception as e:
                    events.put(e)
                events.put(None)
            self.stream_worker.submit(produce)
            first = events.get()
            if isinstance(first, Exception):  # fail before the header
                events.get()
                self._json(500, {"error": f"{type(first).__name__}: {first}"})
                return
            self.send_response(200)
            if audio_mode:
                self.send_header("Content-Type", f"audio/L16;rate="
                                 f"{self.config.sampling_rate}")
            else:
                self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(body: bytes) -> None:  # one chunk, one write
                self.wfile.write(f"{len(body):x}\r\n".encode() + body
                                 + b"\r\n")

            ev = first
            while ev is not None:
                if isinstance(ev, Exception):  # the header has gone out
                    events.get()
                    raise ev
                if audio_mode:
                    if ev.audio is not None:
                        emit(_pcm16(ev.audio).tobytes())
                elif ev.mel is not None:
                    emit(json.dumps({
                        "mel_offset": int(ev.mel_offset),
                        "n_frames": int(ev.mel.shape[0]),
                        "done": bool(ev.done),
                        "mel": ev.mel.tolist(),
                    }).encode() + b"\n")
                ev = events.get()
            self.wfile.write(b"0\r\n\r\n")  # chunked terminator


def make_server(model: Union[tacotron2.Tacotron2, Mapping[str, torch.Tensor]],
                config: Tacotron2Config, port: int = 8080,
                host: str = "127.0.0.1", max_batch: int = 8,
                vocoder_kind: str = "none", vocoder=None, vocoder_cfg=None,
                chunk_steps: int = 32,
                device: Union[str, torch.device] = "cuda"
                ) -> ThreadingHTTPServer:
    """A threaded server (not started: call ``serve_forever``) over one
    copy of the model on ``device``. ``vocoder_kind`` "hifigan" or
    "waveglow" with its module (or state_dict) and config; /stream vocodes
    with HiFi-GAN only (the flow draws its noise over the whole utterance,
    so windowed chunks cannot reproduce it). Stop it with ``shutdown()``
    and then ``RequestHandlerClass.synthesizer.close()``."""
    device = tacotron2.resolve_device(device)
    model = _as_model(model, config).to(device).eval()
    runner = None
    if vocoder_kind != "none":
        runner = VocoderRunner(
            vocoder_kind, vocoder, vocoder_cfg, device=device,
            max_frames=config.max_decoder_steps * config.n_frames_per_step)
    pcm = vocoder_kind == "hifigan"
    streamer = StreamingSynthesizer(
        model, config, vocoder=runner.model if pcm else None,
        vocoder_cfg=vocoder_cfg if pcm else None,
        chunk_steps=chunk_steps, device=device)
    handler = type("BoundHandler", (TTSRequestHandler,), {
        "synthesizer": BatchingSynthesizer(model, config, max_batch=max_batch,
                                           device=device),
        "config": config,
        "device": device,
        "vocoder_kind": vocoder_kind,
        "vocoder_runner": runner,
        "streamer": streamer,
        "stream_lock": threading.Lock(),
        "stream_worker": ThreadPoolExecutor(1, thread_name_prefix="stream"),
    })
    return ThreadingHTTPServer((host, port), handler)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from tacotron2_tpu_torch.config import create_config
    from tacotron2_tpu_torch.infer import load_model, load_vocoder
    from tacotron2_tpu_torch.training.checkpoint import Checkpointer

    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.http_server")
    parser.add_argument("-c", "--checkpoint_dir", required=True,
                        help="a directory of checkpoint_<step>.pt files: "
                             "the latest is served")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--vocoder", default="none",
                        choices=["none", "hifigan", "waveglow"],
                        help="neural vocoder to load for /synthesize wav "
                             "output and /stream PCM output")
    parser.add_argument("--vocoder_checkpoint", default=None)
    parser.add_argument("--chunk_steps", type=int, default=32,
                        help="/stream decoder chunk size (frame groups)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    if args.vocoder != "none" and not args.vocoder_checkpoint:
        parser.error("--vocoder requires --vocoder_checkpoint")
    cfg = create_config(args.hparams)
    device = tacotron2.resolve_device(args.device)
    path = Checkpointer(args.checkpoint_dir).latest()
    if path is None:
        parser.error(f"no checkpoint_<step>.pt in {args.checkpoint_dir}")
    model = load_model(path, cfg, device=device)
    vocoder = vocoder_cfg = None
    if args.vocoder != "none":
        vocoder, vocoder_cfg = load_vocoder(
            args.vocoder, args.vocoder_checkpoint, cfg, device=device)
    server = make_server(model, cfg, args.port, args.host, args.max_batch,
                         vocoder_kind=args.vocoder, vocoder=vocoder,
                         vocoder_cfg=vocoder_cfg,
                         chunk_steps=args.chunk_steps, device=device)
    print(f"serving {path} on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        server.RequestHandlerClass.synthesizer.close()


if __name__ == "__main__":
    main()
