"""Row-slabbed matrices over the ranks of a process group: the operations
that let ``core/eigh_dc.py`` split its n-sized products over a mesh's
``sample`` ranks.

An (n, m) matrix is held as row slabs: rank j of a group of s ranks holds
rows [lo_j, hi_j), the first n % s ranks one row more than the others.
The decomposition's n x n matrices (A, the sign iterate, the projector)
are symmetric or polynomials in a symmetric matrix, and its tall blocks
(sketches, bases) are (n, m); all of them are row-slabbed, so no rank ever
holds a whole n x n float64 iterate.

* :meth:`Slabs.mm`, the ring product: rank r's rows of X Y are
  ``sum_j X_r[:, cols_j] Y_j`` over the slabs Y_j of Y, which pass once
  around the ring, so a rank holds its own slab, one slab in flight and its
  output.
* :meth:`Slabs.gram`, V'W = sum_r V_r' W_r, all-reduced (CholeskyQR2,
  the block Gram-Schmidt projections, the Ritz sketches).
* :meth:`Slabs.qr_q`, Householder TSQR: a QR of each slab, a QR of the
  stacked R factors on the group's first rank, then a local product; its
  columns are exactly orthonormal for a rank-deficient block too.
* :meth:`Slabs.pencil`, the split's pencil reduced straight into the two
  children's row layouts; the children then run at once, each on its half
  of the group (:class:`SlabGroup`).
* reductions (max, sum, column norms) and the diagonal at the slab's
  column offset.

Every small factorization (a Cholesky, the Ritz step's eigh, the stacked
R's QR, a leaf eigh, the host's Ritz pencil) runs on the group's first rank
and is broadcast, and every value that steers the host's control flow is
all-reduced, so the ranks take the same branches and agree on every
basis column.  :data:`WHOLE` is the same interface on whole matrices in
one process: plain ``torch`` calls, the one-process eigh_dc unchanged.

Transport: device tensors under NCCL; under gloo (ranks sharing a card,
or the CPU) each message is staged through the host.  Every product stays
``torch.matmul``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import distributed


def bounds(n: int, size: int) -> List[Tuple[int, int]]:
    """The rows [lo, hi) of each of ``size`` slabs of n rows."""
    base, extra = divmod(n, size)
    edges = [j * base + min(j, extra) for j in range(size + 1)]
    return list(zip(edges[:-1], edges[1:]))


class SlabGroup:
    """A group of ranks and the halves its split's children run on, down
    to single ranks.  Every rank of the world builds the same tree, in the
    same order, since ``dist.new_group`` is collective over the world."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        me = dist.get_rank()
        self.index = self.ranks.index(me) if me in self.ranks else None
        self.group = None
        self.children = None
        if self.size > 1:
            self.group = dist.new_group(self.ranks)
            half = self.size // 2
            self.children = (SlabGroup(self.ranks[:half]),
                             SlabGroup(self.ranks[half:]))


class Whole:
    """The one-process layout: every operation is the plain ``torch`` call
    on a whole matrix."""

    tree = None
    leader = True

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return full

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        return X.diagonal()

    def mm(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return torch.matmul(X, Y)

    def gram(self, V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        return torch.matmul(V.T, W)

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        return t.amax()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t.sum()

    def colnorm(self, V: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        return torch.linalg.vector_norm(V, dim=0, keepdim=keepdim)

    def coldot(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ij,ij->j", U, V)

    def all_finite(self, t: torch.Tensor) -> bool:
        return bool(torch.isfinite(t))

    def small(self, fn: Callable, *args):
        return fn(*args)

    def on_leader(self, fn: Callable, *args):
        return fn(*args)

    def qr_q(self, Y: torch.Tensor) -> torch.Tensor:
        return torch.linalg.qr(Y).Q

    def eye_half(self, like: torch.Tensor) -> torch.Tensor:
        n = like.shape[1]
        return 0.5 * torch.eye(n, dtype=like.dtype, device=like.device)

    def gather_rows(self, V: torch.Tensor) -> torch.Tensor:
        return V

    def leaf(self, A: torch.Tensor, fn: Callable):
        return fn(A)

    def pencil(self, U_split, AV, r_lo: int):
        """The stacked pencil M = U_split' A U_split and its coupling block's
        largest entry."""
        M = torch.matmul(U_split.T, AV)
        return M, M[r_lo:, :r_lo].abs().amax()

    def blocks(self, M, r_lo: int):
        """The symmetrized diagonal blocks of the pencil: the children's
        Rayleigh matrices."""
        A_lo = 0.5 * (M[:r_lo, :r_lo] + M[:r_lo, :r_lo].T)
        A_hi = 0.5 * (M[r_lo:, r_lo:] + M[r_lo:, r_lo:].T)
        return A_lo, A_hi


#: the one-process layout
WHOLE = Whole()


class Slabs:
    """Row slabs of n-row matrices over the ranks of a :class:`SlabGroup`
    that holds this rank; the tensors passed in are this rank's slabs."""

    leader: bool
    #: bytes this process has handed to the transport (every send, every
    #: contribution to a reduction), over all its Slabs
    sent_bytes = 0

    def __init__(self, tree: SlabGroup, n: int, device: torch.device):
        if n < tree.size:
            raise ValueError(f"{n} rows cannot be slabbed over {tree.size} "
                             "ranks")
        self.tree = tree
        self.n = n
        self.device = device
        self.me = tree.index
        self.leader = self.me == 0
        self.edges = bounds(n, tree.size)
        self.lo, self.hi = self.edges[self.me]
        self.staged = dist.get_backend(tree.group) != "nccl"

    # --- transport ---------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as this rank sends it (on the host under gloo), counted in
        :attr:`sent_bytes`."""
        Slabs.sent_bytes += t.numel() * t.element_size()
        return self._stage(t)

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def _buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           device="cpu" if self.staged else self.device)

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        w = self._wire(t)
        dist.all_reduce(w, op=op, group=self.tree.group)
        return w.to(self.device)

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` (``src`` a global rank) on every rank of the
        group; what the others pass is ignored."""
        if dist.get_rank() == src:
            Slabs.sent_bytes += t.numel() * t.element_size()
        return distributed.broadcast(t, self.device, src, self.tree.group)

    def _exchange(self, send: Optional[Tuple[torch.Tensor, int]],
                  recv: List[Tuple[torch.Tensor, int]]) -> None:
        """Point-to-point sends and receives (tensor, global rank), all
        posted at once."""
        ops = [dist.P2POp(dist.isend, send[0], send[1], self.tree.group)
               ] if send is not None else []
        ops += [dist.P2POp(dist.irecv, t, peer, self.tree.group)
                for t, peer in recv]
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()

    # --- layout ------------------------------------------------------------
    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a matrix every rank holds whole (a seeded
        draw), as a copy, so the whole one can be freed."""
        return full[self.lo:self.hi].clone()

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        """The diagonal entries in this rank's rows (a writable view)."""
        return X[:, self.lo:self.hi].diagonal()

    def eye_half(self, like: torch.Tensor) -> torch.Tensor:
        P = torch.zeros((self.hi - self.lo, self.n), dtype=like.dtype,
                        device=like.device)
        self.diag(P).fill_(0.5)
        return P

    def gather_rows(self, V: torch.Tensor) -> torch.Tensor:
        """The whole matrix on every rank, its rows in the same bytes
        everywhere: each slab broadcast from the rank that holds it."""
        full = torch.empty((self.n,) + tuple(V.shape[1:]), dtype=V.dtype,
                           device=self.device)
        for src, (lo, hi) in zip(self.tree.ranks, self.edges):
            full[lo:hi] = self._broadcast(V, src)
        return full

    def _gather_to_leader(self, V: torch.Tensor, counts: Sequence[int]):
        """Every rank's (counts[j], m) block stacked on the group's first
        rank (None elsewhere)."""
        ranks = self.tree.ranks
        if not self.leader:
            self._exchange((self._wire(V), ranks[0]), [])
            return None
        parts = [self._buffer((c,) + tuple(V.shape[1:]), V.dtype)
                 for c in counts[1:]]
        self._exchange(None, list(zip(parts, ranks[1:])))
        return torch.cat([V] + [p.to(self.device) for p in parts])

    def _scatter_from_leader(self, full: Optional[torch.Tensor],
                             counts: Sequence[int], cols: int,
                             dtype) -> torch.Tensor:
        """Block j of the leader's stacked rows (counts[j] rows) on rank j."""
        ranks = self.tree.ranks
        if not self.leader:
            buf = self._buffer((counts[self.me], cols), dtype)
            self._exchange(None, [(buf, ranks[0])])
            return buf.to(self.device)
        offs = [0]
        for c in counts:
            offs.append(offs[-1] + c)
        for j in range(1, len(counts)):
            self._exchange((self._wire(full[offs[j]:offs[j + 1]]), ranks[j]),
                           [])
        return full[:counts[0]]

    # --- products ----------------------------------------------------------
    def mm(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of X Y, for X's row slab (rows, n) and the
        row-slabbed Y (n, m): Y's slabs pass around the ring, the next one
        in flight while the current one is multiplied."""
        s, ranks = self.tree.size, self.tree.ranks
        nxt, prv = ranks[(self.me + 1) % s], ranks[(self.me - 1) % s]
        src, cur, wire = self.me, Y, self._stage(Y)
        out = None
        for step in range(s):
            reqs = None
            if step < s - 1:
                lo, hi = self.edges[(src - 1) % s]
                nbuf = self._buffer((hi - lo,) + tuple(Y.shape[1:]), Y.dtype)
                Slabs.sent_bytes += wire.numel() * wire.element_size()
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, wire, nxt, self.tree.group),
                    dist.P2POp(dist.irecv, nbuf, prv, self.tree.group)])
            lo, hi = self.edges[src]
            part = torch.matmul(X[:, lo:hi], cur)
            out = part if out is None else out.add_(part)
            del part
            if reqs is not None:
                for req in reqs:
                    req.wait()
                src, wire = (src - 1) % s, nbuf
                cur = nbuf.to(self.device)
        return out

    def gram(self, V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """V'W, all-reduced over the group's slabs."""
        return self._all_reduce(torch.matmul(V.T, W))

    def qr_q(self, Y: torch.Tensor) -> torch.Tensor:
        """Householder TSQR: exactly orthonormal columns spanning Y's, as
        row slabs."""
        m = Y.shape[1]
        Q1, R1 = torch.linalg.qr(Y)
        counts = [min(hi - lo, m) for lo, hi in self.edges]
        R = self._gather_to_leader(R1, counts)
        Q2 = torch.linalg.qr(R).Q if self.leader else None
        return torch.matmul(Q1, self._scatter_from_leader(Q2, counts, m,
                                                          Y.dtype))

    # --- reductions --------------------------------------------------------
    def amax(self, t: torch.Tensor) -> torch.Tensor:
        """The largest entry over the group; NaN if any rank's has one (a
        max all-reduce does not carry NaN)."""
        local = torch.stack([torch.nan_to_num(t.amax(), nan=-torch.inf),
                             t.isnan().any().to(t.dtype)])
        got = self._all_reduce(local, dist.ReduceOp.MAX)
        return torch.where(got[1] > 0, torch.nan, got[0])

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t.sum())

    def colnorm(self, V: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        return self._all_reduce((V * V).sum(0, keepdim=keepdim)).sqrt_()

    def coldot(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(torch.einsum("ij,ij->j", U, V))

    def all_finite(self, t: torch.Tensor) -> bool:
        bad = (~torch.isfinite(t)).to(torch.int32).reshape(1)
        return int(self._all_reduce(bad, dist.ReduceOp.MAX)) == 0

    # --- work on the group's first rank ------------------------------------
    def small(self, fn: Callable, *args):
        """``fn(*args)`` (a tuple of tensors) computed on the group's first
        rank and broadcast: a factorization every rank must agree on to
        the bit."""
        out = distributed.from_src(lambda: tuple(fn(*args)), self.device,
                                   self.tree.ranks[0], self.tree.group)
        if self.leader:
            Slabs.sent_bytes += sum(t.numel() * t.element_size() for t in out)
        return out

    def on_leader(self, fn: Callable, *args):
        """``fn(*args)`` (a host value) from the group's first rank."""
        return distributed.broadcast_object(
            fn(*args) if self.leader else None, self.tree.ranks[0],
            self.tree.group)

    def leaf(self, A: torch.Tensor, fn: Callable):
        """``fn`` of the whole matrix, on the group's first rank, its result
        broadcast."""
        counts = [hi - lo for lo, hi in self.edges]
        full = self._gather_to_leader(A, counts)
        return self.small(lambda: fn(full))

    # --- the split ---------------------------------------------------------
    def _child_rows(self, r_lo: int):
        """(side, child rank's global rank, rows in the pencil's
        coordinates, the child's columns) of every rank of the group, lo
        child's ranks first."""
        out = []
        n_side = (r_lo, self.n - r_lo)
        off = (0, r_lo)
        for side, child in enumerate(self.tree.children):
            for g, (lo, hi) in zip(child.ranks, bounds(n_side[side],
                                                       child.size)):
                out.append((side, g, slice(off[side] + lo, off[side] + hi),
                            slice(off[side], off[side] + n_side[side])))
        return out

    def pencil(self, U_split, AV, r_lo: int):
        """The pencil U_split' A U_split reduced into the children's layouts:
        each rank receives its child's rows of that child's symmetrized
        Rayleigh block, and a rank of the high child also the raw coupling
        rows (its rows, the low block's columns).  Returns ((side, rows),
        the coupling block's largest entry over the group)."""
        mine = None
        coupling = None
        for side, g, rows, cols in self._child_rows(r_lo):
            part = 0.5 * (torch.matmul(U_split[:, rows].T, AV[:, cols])
                          + torch.matmul(AV[:, rows].T, U_split[:, cols]))
            if side == 1:
                part = torch.cat([part, torch.matmul(U_split[:, rows].T,
                                                     AV[:, :r_lo])], dim=1)
            w = self._wire(part)
            del part
            dist.reduce(w, dst=g, group=self.tree.group)
            if g == dist.get_rank():
                got = w.to(self.device)
                block = got[:, :got.shape[1] - (r_lo if side else 0)]
                if side == 1:
                    coupling = got[:, block.shape[1]:].abs()
                mine = (side, block)
        local = coupling if coupling is not None else torch.zeros(
            1, dtype=AV.dtype, device=self.device)
        return mine, self.amax(local)

    def blocks(self, M, r_lo: int):
        """(A_lo, A_hi): this rank's rows of its child's block in its slot,
        None in the other."""
        side, block = M
        return (block, None) if side == 0 else (None, block)

    def share(self, ev: torch.Tensor, U: torch.Tensor):
        """Each child's (ev, U), which its ranks hold whole, broadcast from
        the child's first rank to the whole group: ((ev_lo, U_lo), (ev_hi,
        U_hi))."""
        return tuple((self._broadcast(ev, child.ranks[0]),
                      self._broadcast(U, child.ranks[0]))
                     for child in self.tree.children)
