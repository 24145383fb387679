"""Frame cap and vectored send (the port's own copy of what the KV handoff
needs from gofr_tpu/fleet/channel.py: ``MAX_FRAME_BYTES`` :60 and
``sendmsg_all`` :91; the lockstep channel itself is not ported)."""

from __future__ import annotations

import socket

# Frame-size sanity cap, both directions. A corrupt or hostile length
# prefix would otherwise make a reader allocate the advertised bytes
# outright (silent multi-GB OOM); an oversized send is a caller bug that
# must fail loudly. The largest legitimate frames are multi-MB KV-page
# payloads (gpu/handoff.py), far below 256 MiB.
MAX_FRAME_BYTES = 256 << 20

# sendmsg takes at most IOV_MAX iovecs per call (1024 on Linux); batching
# below it keeps one syscall per chunk without ever tripping EMSGSIZE
_IOV_BATCH = 64


def sendmsg_all(sock: socket.socket, parts) -> int:
    """Vectored (scatter-gather) send: write every buffer in ``parts`` in
    order WITHOUT joining them into one bytes object — the ``sendmsg``
    analog of ``sendall``, handling partial writes by slicing memoryviews
    rather than re-packing. A multi-MB page frame goes out as [header,
    meta, plane, plane, ...] views over the original buffers, never as one
    concatenated copy. Returns the total bytes written."""
    bufs = []
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        if mv.nbytes:
            bufs.append(mv.cast("B") if mv.format != "B" or mv.ndim != 1 else mv)
    total = sum(b.nbytes for b in bufs)
    while bufs:
        try:
            sent = sock.sendmsg(bufs[:_IOV_BATCH])
        except AttributeError:  # platform without sendmsg
            for b in bufs:
                sock.sendall(b)
            return total
        while sent:
            if sent >= bufs[0].nbytes:
                sent -= bufs[0].nbytes
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][sent:]
                sent = 0
    return total
