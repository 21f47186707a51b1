"""Out-of-process scoring sidecar over a unix domain socket, on the GPU.

The port of ``odigos_tpu/serving/sidecar.py``: the collector keeps its
latency budget and pass-through discipline while the scoring model lives
in a separate process. The wire protocol is identical, so the JAX
package's ``SidecarClient`` / ``RemoteBackend`` talk to this server and the
port's client talks to the JAX server.

Wire protocol (little-endian), framed like wire/codec.py:

    frame   := magic "OTS1" | u32 payload_len | payload
    payload := u32 req_id | u8 op | body
    ops     : SCORE  (body = wire.codec.encode_batch)   → scores response
              WARMUP (body = wire.codec.encode_batch)   → empty response
              PING   (empty body)                       → empty response
    reply   := u32 req_id | u8 status (0 ok / 1 error) | body
               SCORE body = raw float32[n] scores; error body = utf-8 message

A server-side scoring timeout answers ST_ERROR.

Client side: ``RemoteBackend`` plugs into the port's ``ScoringEngine`` as
the ``"remote"`` model (``EngineConfig(model="remote", socket_path=...)``),
so the engine's queue admission, coalescing and ``score_sync`` deadline
still apply; the round trip runs on the engine's worker thread at depth 1,
and a failed or short reply fails the group (an engine error, the spans
pass through). It talks to this server or to the JAX package's. The first calls on the
card pay the kernel build, CUDA context and module load, so ``main`` warms
every bucket-ladder rung (zscore: every span bucket) before it binds the
socket (``--no-warm-ladder`` turns that off).

Run standalone:  python -m odigos_tpu_torch.serving.sidecar \\
                     --socket /tmp/score.sock [--model zscore] [--device cuda]
                     [--model transformer --checkpoint <bundle>]

``--model`` is ``zscore`` (the default, as in the JAX package: WARMUP
fits the detector), ``transformer``, ``autoencoder`` or ``mock``.
``--checkpoint`` serves a trained serving bundle (``Trainer.export``; a
JAX package bundle converts with ``tools/torch_import_bundle.py``): its
geometry and weights win. Without one the sequence models' weights are
random, drawn from ``EngineConfig.seed``.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Any, Optional

import numpy as np

from ..pdata.spans import SpanBatch
from ..utils.framing import (
    ConnRegistry, connect_unix_retry, recv_frame, send_frame, shutdown_close)
from ..utils.telemetry import meter
from ..wire.codec import decode_batch, encode_batch

MAGIC = b"OTS1"
MAX_FRAME = 256 << 20  # span batches are big; beyond this is corruption
_REQ = struct.Struct("<IB")  # req_id, op/status

OP_SCORE = 0
OP_WARMUP = 1
OP_PING = 2

ST_OK = 0
ST_ERROR = 1

REMOTE_ERRORS_METRIC = "odigos_sidecar_client_errors_total"


# ----------------------------------------------------------------- framing

def _send_frame(sock: socket.socket, req_id: int, op: int,
                body: bytes = b"") -> None:
    send_frame(sock, MAGIC, _REQ.pack(req_id, op) + body)


def _recv_frame(sock: socket.socket) -> Optional[tuple[int, int, bytes]]:
    payload = recv_frame(sock, MAGIC, MAX_FRAME)
    if payload is None:
        return None
    if len(payload) < _REQ.size:
        raise ValueError(f"sidecar frame too short: {len(payload)}")
    req_id, op = _REQ.unpack_from(payload, 0)
    return req_id, op, payload[_REQ.size:]


# ------------------------------------------------------------------ server

class SidecarServer:
    """Serves Score() for one ScoringEngine over a unix socket.

    One accept loop, one reader thread per connection, one handler thread
    per in-flight request (requests block on the shared engine, which
    coalesces them into large device calls).
    """

    def __init__(self, engine, socket_path: str,
                 score_timeout_s: float = 5.0, max_inflight: int = 64):
        self.engine = engine
        self.socket_path = socket_path
        self.score_timeout_s = score_timeout_s
        # admission control at the accept boundary: thread-per-request
        # must not become a thread bomb behind a slow engine
        self._inflight = threading.Semaphore(max_inflight)
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._conns = ConnRegistry()

    def start(self) -> "SidecarServer":
        self.engine.start()  # warms the ladder first when configured to
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        threading.Thread(target=self._accept_loop, name="sidecar-accept",
                         daemon=True).start()
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            self._stop.wait()
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # close accepted connections too, or same-process clients blocked
        # in recv never see EOF
        self._conns.close_all()
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        self.engine.shutdown()

    # ------------------------------------------------------------ internals

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="sidecar-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()  # replies from handler threads interleave
        self._conns.add(conn)
        try:
            while not self._stop.is_set():
                got = _recv_frame(conn)
                if got is None:
                    return
                req_id, op, body = got
                if not self._inflight.acquire(blocking=False):
                    try:
                        with wlock:
                            _send_frame(conn, req_id, ST_ERROR,
                                        b"sidecar overloaded")
                    except OSError:
                        return
                    continue
                threading.Thread(
                    target=self._handle, name="sidecar-req", daemon=True,
                    args=(conn, wlock, req_id, op, body)).start()
        except (OSError, ValueError):
            return
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn, wlock, req_id: int, op: int, body: bytes) -> None:
        try:
            self._handle_inner(conn, wlock, req_id, op, body)
        finally:
            self._inflight.release()

    def _handle_inner(self, conn, wlock, req_id: int, op: int,
                      body: bytes) -> None:
        try:
            if op == OP_PING:
                reply = (ST_OK, b"")
            elif op == OP_WARMUP:
                self.engine.warmup(decode_batch(body))
                reply = (ST_OK, b"")
            elif op == OP_SCORE:
                scores = self.engine.score_sync(
                    decode_batch(body), timeout_s=self.score_timeout_s)
                if scores is None:
                    reply = (ST_ERROR, b"scoring timed out in sidecar")
                else:
                    reply = (ST_OK,
                             np.ascontiguousarray(scores, np.float32)
                             .tobytes())
            else:
                reply = (ST_ERROR, f"unknown op {op}".encode())
        except Exception as e:  # noqa: BLE001 — report, don't kill the conn
            reply = (ST_ERROR, f"{type(e).__name__}: {e}".encode())
        status, rbody = reply
        try:
            with wlock:
                _send_frame(conn, req_id, status, rbody)
        except OSError:
            pass


# ------------------------------------------------------------------ client

class SidecarClient:
    """Thread-safe request/response client with a reader thread."""

    def __init__(self, socket_path: str, connect_timeout_s: float = 5.0):
        self.socket_path = socket_path
        self.connect_timeout_s = connect_timeout_s
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._clock = threading.Lock()  # serializes lazy connect()
        self._pending: dict[int, dict[str, Any]] = {}
        self._plock = threading.Lock()
        self._next_id = 0
        self._reader: Optional[threading.Thread] = None

    def _new_waiter(self) -> tuple[int, dict[str, Any]]:
        with self._plock:
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            rec = {"event": threading.Event(), "status": None, "body": None}
            self._pending[self._next_id] = rec
            return self._next_id, rec

    def connect(self) -> None:
        with self._clock:  # concurrent first requests connect exactly once
            if self._sock is not None:
                return
            s = connect_unix_retry(self.socket_path, self.connect_timeout_s)
            self._sock = s
            self._reader = threading.Thread(
                target=self._read_loop, args=(s,),
                name="sidecar-client-reader", daemon=True)
            self._reader.start()

    def close(self) -> None:
        with self._clock:
            sock, self._sock = self._sock, None
        if sock is not None:
            shutdown_close(sock)  # the reader blocks in recv

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                got = _recv_frame(sock)
                if got is None:
                    break
                req_id, status, body = got
                with self._plock:
                    rec = self._pending.pop(req_id, None)
                if rec is not None:
                    rec["status"], rec["body"] = status, body
                    rec["event"].set()
        except (OSError, ValueError):
            pass
        # connection died: drop the dead socket so the next request()
        # reconnects, then fail everything in flight
        with self._clock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass
        with self._plock:
            pending, self._pending = self._pending, {}
        for rec in pending.values():
            rec["status"], rec["body"] = ST_ERROR, b"connection lost"
            rec["event"].set()

    def request(self, op: int, body: bytes = b"",
                timeout_s: float = 30.0) -> bytes:
        if self._sock is None:
            self.connect()
        with self._clock:
            sock = self._sock
        if sock is None:
            raise ConnectionError("sidecar connection lost")
        req_id, rec = self._new_waiter()
        try:
            with self._wlock:
                _send_frame(sock, req_id, op, body)
        except OSError as e:
            with self._plock:
                self._pending.pop(req_id, None)
            self.close()
            raise ConnectionError(f"sidecar send failed: {e}") from e
        if not rec["event"].wait(timeout_s):
            with self._plock:
                self._pending.pop(req_id, None)
            raise TimeoutError("sidecar response timed out")
        if rec["status"] != ST_OK:
            raise RuntimeError(
                f"sidecar error: {rec['body'].decode(errors='replace')}")
        return rec["body"]

    def ping(self, timeout_s: float = 5.0) -> None:
        self.request(OP_PING, timeout_s=timeout_s)

    def score(self, batch: SpanBatch, timeout_s: float = 30.0) -> np.ndarray:
        body = self.request(OP_SCORE, encode_batch(batch), timeout_s)
        return np.frombuffer(body, np.float32).copy()

    def warmup(self, batch: SpanBatch, timeout_s: float = 120.0) -> None:
        self.request(OP_WARMUP, encode_batch(batch), timeout_s)


class RemoteBackend:
    """ScoringEngine backend that scores through a sidecar process.

    Registered as model ``"remote"``: the engine keeps its local queue
    admission, coalescing and deadline; only the scoring call crosses the
    process boundary, and the sidecar's own engine owns the card. Errors
    are counted here and raised: the engine fails the group and the spans
    pass through.
    """

    # the sidecar featurizes server-side; the client engine must not
    # featurize too (twice the host cost against the latency budget)
    needs_features = False
    # no dispatch: the socket round trip carries its own deadline
    # (remote_timeout_s), and overlapping calls here would reorder the
    # sidecar's cross-connection coalescing — the client engine runs this
    # backend at depth 1 and the SERVER engine, which owns the card,
    # pipelines
    device_label = "remote"

    def __init__(self, cfg):
        if not cfg.socket_path:
            raise ValueError("model 'remote' requires socket_path")
        self.cfg = cfg
        self.client = SidecarClient(cfg.socket_path)

    def score(self, batch: SpanBatch, features: Any) -> np.ndarray:
        try:
            # the deadline bounds how long a stalled (not dead) sidecar
            # can pin the engine's worker thread
            scores = self.client.score(
                batch, timeout_s=self.cfg.remote_timeout_s)
        except (ConnectionError, TimeoutError, RuntimeError):
            meter.add(REMOTE_ERRORS_METRIC)
            raise
        if len(scores) != len(batch):
            raise RuntimeError(
                f"sidecar returned {len(scores)} scores for "
                f"{len(batch)} spans")
        return scores

    def warmup(self, batch: SpanBatch) -> None:
        self.client.warmup(batch)


# -------------------------------------------------------------- standalone

def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="odigos-tpu-torch scoring sidecar (unix-socket Score "
                    "server on the GPU)")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--model", default="zscore",
                    choices=["zscore", "transformer", "autoencoder",
                             "mock"])
    ap.add_argument("--checkpoint", default=None,
                    help="serving bundle (Trainer.export) for the "
                         "transformer/autoencoder; its geometry wins")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--trace-bucket", type=int, default=256)
    ap.add_argument("--timeout-ms", type=float, default=5000.0,
                    help="server-side scoring deadline")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight device calls (sequence models; 1 = "
                         "serial; zscore and mock always run serially)")
    ap.add_argument("--bucket-ladder", type=int, default=4,
                    help="geometric row-shape buckets above --trace-bucket "
                         "(sequence models)")
    ap.add_argument("--warm-ladder", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run every ladder rung (zscore: span bucket) "
                         "before serving (default on: the first call "
                         "otherwise pays the kernel build)")
    return ap


def engine_config(args) -> "EngineConfig":
    """The engine configuration ``main`` serves for parsed arguments."""
    from .engine import EngineConfig

    return EngineConfig(
        model=args.model, device=args.device,
        checkpoint_path=args.checkpoint,
        max_len=args.max_len, trace_bucket=args.trace_bucket,
        pipeline_depth=args.pipeline_depth,
        bucket_ladder=args.bucket_ladder, warm_ladder=args.warm_ladder)


def main(argv: Optional[list[str]] = None) -> None:
    from .engine import ScoringEngine

    args = build_parser().parse_args(argv)
    engine = ScoringEngine(engine_config(args))
    server = SidecarServer(engine, args.socket,
                           score_timeout_s=args.timeout_ms / 1000.0)
    print(f"sidecar: model={args.model} device={engine.backend.device_label} "
          f"socket={args.socket}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
