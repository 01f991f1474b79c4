"""Consistent-hash ring for the elastic PS server tier.

Counterpart of ``byteps_tpu/common/ring.py`` (a copy: the port imports
nothing of the JAX package).  This is the worker-side half of the one
placement law shared with the C++ server (``core/server.cc``,
``namespace ring``): a splitmix64-hashed ring with
``BYTEPS_TPU_RING_VNODES`` virtual nodes per server.  A partition key is
owned by the server whose first virtual-node point is clockwise at or
after the key's point.  Both sides must compute bit-identical owners
(``_CCore.ring_owner`` reads the library's ``bps_ring_owner``), because
the server rejects frames for keys it does not own (status ``MOVED``)
once the ring epoch has advanced, and a placement disagreement would
turn every push into a redirect loop.

Placement law by mode:
  - ring unarmed (``BYTEPS_TPU_RING`` unset, the default): the fixed hash
    (``Core.key_to_server``, djb2 modulo), and no ring frame is sent;
  - ring armed: the ring over the current member set, from epoch 0 on.
    Adding a server moves about 1/N of the keys, all of them to the
    joiner; removing one moves only its keys, all to survivors.

The ring table is epoch-versioned: every server join, drain or eviction
bumps the epoch, servers accept a ``CMD_RING_SET`` only for a newer
epoch, and a fixed topology stays at epoch 0.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_M64 = (1 << 64) - 1

DEFAULT_VNODES = 64


def splitmix64(x: int) -> int:
    """The shared 64-bit mixer (bit-identical to server.cc ring::Mix64)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def vnode_point(server_id: int, vnode: int) -> int:
    """Ring point of one virtual node.  ``id+1`` so server 0's points
    are not the bare vnode indices; the shift keeps id and vnode in
    disjoint bit ranges before mixing."""
    return splitmix64((((server_id + 1) << 32) | vnode) & _M64)


def key_point(key: int) -> int:
    return splitmix64(key & _M64)


def build_points(server_ids, vnodes: int = DEFAULT_VNODES
                 ) -> List[Tuple[int, int]]:
    """Sorted [(point, server_id)] for the given member set."""
    pts = [(vnode_point(s, v), s)
           for s in server_ids for v in range(vnodes)]
    pts.sort()
    return pts


def owner_of(key: int, points: List[Tuple[int, int]]) -> int:
    """Server id owning ``key``: first vnode point >= the key's point,
    wrapping to the smallest point (classic consistent hashing)."""
    if not points:
        raise ValueError("ring has no members")
    kp = key_point(key)
    lo, hi = 0, len(points)
    while lo < hi:
        mid = (lo + hi) // 2
        if points[mid][0] < kp:
            lo = mid + 1
        else:
            hi = mid
    return points[lo % len(points)][1]


def successor_of(key: int, points: List[Tuple[int, int]]) -> int:
    """Replication target for ``key``: the owner of the ring with the
    key's OWNER's vnodes removed — i.e. the next DISTINCT server along
    the ring.  This is the Python mirror of the C++ `repl_points_` law
    (server.cc CMD_REPL): owner and successor must agree from both
    sides, or a failover would look for the replica on the wrong
    server.  Raises ValueError on a single-member ring (no distinct
    successor exists; the owner self-acks there)."""
    own = owner_of(key, points)
    rest = [(p, s) for p, s in points if s != own]
    if not rest:
        raise ValueError("ring has a single member: no successor")
    return owner_of(key, rest)


class RingTable:
    """One worker's view of the server ring: epoch, members (id ->
    address), and the precomputed point table.

    ``servers`` is ``[(id, host, port), ...]``.  Addresses are what THIS
    worker dials (they may be chaos-proxy addresses in tests); the
    server tier keeps its own peer address book for migrations.
    """

    def __init__(self, servers: List[Tuple[int, str, int]],
                 vnodes: int = DEFAULT_VNODES, epoch: int = 0):
        self.epoch = int(epoch)
        self.vnodes = max(1, int(vnodes))
        self.servers: List[Tuple[int, str, int]] = [
            (int(i), str(h), int(p)) for i, h, p in servers]
        self._points = build_points([i for i, _, _ in self.servers],
                                    self.vnodes)

    # -- placement ----------------------------------------------------------
    def owner(self, key: int) -> int:
        return owner_of(key, self._points)

    def successor(self, key: int) -> int:
        """The key's replication target (see ``successor_of``)."""
        return successor_of(key, self._points)

    def ids(self) -> List[int]:
        return [i for i, _, _ in self.servers]

    def address(self, server_id: int) -> Optional[Tuple[str, int]]:
        for i, h, p in self.servers:
            if i == server_id:
                return h, p
        return None

    # -- transitions --------------------------------------------------------
    def without(self, server_id: int) -> "RingTable":
        """The next-epoch ring with ``server_id`` removed (drain /
        failover proposal)."""
        rest = [(i, h, p) for i, h, p in self.servers if i != server_id]
        if not rest:
            raise ValueError("cannot remove the last ring member")
        return RingTable(rest, self.vnodes, self.epoch + 1)

    def with_server(self, server_id: int, host: str,
                    port: int) -> "RingTable":
        """The next-epoch ring with a joiner added (scale-up)."""
        rest = [(i, h, p) for i, h, p in self.servers if i != server_id]
        rest.append((int(server_id), str(host), int(port)))
        return RingTable(rest, self.vnodes, self.epoch + 1)

    # -- wire formats -------------------------------------------------------
    # Client -> server (CMD_RING_SET / CMD_DRAIN payload) is binary —
    # the C++ side stays free of JSON parsing:
    #   u64 epoch | u32 vnodes | u32 n | n x (u32 id | u16 port |
    #   u8 host_len | host_utf8)
    def to_wire(self) -> bytes:
        out = [struct.pack("<QII", self.epoch, self.vnodes,
                           len(self.servers))]
        for i, h, p in self.servers:
            hb = h.encode()
            out.append(struct.pack("<IHB", i, p, len(hb)) + hb)
        return b"".join(out)

    # Server -> client (CMD_RING response / MOVED payload) is JSON.
    @classmethod
    def from_json(cls, doc: dict) -> "RingTable":
        servers = [(int(s["id"]), str(s.get("host", "")),
                    int(s.get("port", 0)))
                   for s in doc.get("servers", [])]
        return cls(servers, int(doc.get("vnodes", DEFAULT_VNODES)),
                   int(doc.get("epoch", 0)))

    def describe(self) -> Dict:
        return {"epoch": self.epoch, "vnodes": self.vnodes,
                "servers": [{"id": i, "host": h, "port": p}
                            for i, h, p in self.servers]}


def moved_fraction(old: RingTable, new: RingTable,
                   keys) -> float:
    """Fraction of ``keys`` whose owner differs between two rings — the
    stability metric the ring exists for (adding one of N+1 servers
    should move ~1/(N+1) of the keys, and only TO the new server)."""
    keys = list(keys)
    if not keys:
        return 0.0
    moved = sum(1 for k in keys if old.owner(k) != new.owner(k))
    return moved / len(keys)
