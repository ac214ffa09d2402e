"""The server's binary frames, numpy and the standard library only.

Copied from ``gossipnet_tpu_torch/tools/tcp_bench_client.py`` at commit
278085c491085865767fbb28b435e49130c47800 (``BIN_MAGIC``, the request
header ``<IQII``, ``_recv_exact``, ``_read_reply_bin``), the frame
protocol of ``gossipnet_tpu_torch/serving.py``; the reply reader here
returns the request id and the scores instead of discarding them.

Request: u32 magic, u64 id, u32 n, u32 flags, n*4 f32 boxes, n f32 scores.
Reply: u32 magic, u8 status, u64 id; ok: u32 n, n f32 scores, u32 k,
k i32 keep; error: u32 len, len bytes of message.
"""

import struct

import numpy as np

BIN_MAGIC = 0x544E4E47


def request(rid: int, boxes: np.ndarray, scores: np.ndarray) -> bytes:
    return (struct.pack("<IQII", BIN_MAGIC, rid, len(scores), 0)
            + np.asarray(boxes, "<f4").tobytes()
            + np.asarray(scores, "<f4").tobytes())


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def read_reply(sock):
    """One reply -> (id, scores float32 or None for an error frame)."""
    magic, status, rid = struct.unpack("<IBQ", recv_exact(sock, 13))
    if magic != BIN_MAGIC:
        raise ConnectionError(f"bad reply magic 0x{magic:08x}")
    if status != 0:
        (ln,) = struct.unpack("<I", recv_exact(sock, 4))
        recv_exact(sock, ln)
        return rid, None
    (n,) = struct.unpack("<I", recv_exact(sock, 4))
    scores = np.frombuffer(recv_exact(sock, 4 * n), "<f4")
    (k,) = struct.unpack("<I", recv_exact(sock, 4))
    recv_exact(sock, 4 * k)
    return rid, scores
