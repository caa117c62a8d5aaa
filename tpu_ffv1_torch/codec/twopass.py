"""Two-pass statistics: the port's copy of ``tpu_ffv1/codec/twopass.py``.

Pass 1 counts every binary decision of the slice data twice: by the
coder state before it (``rc_stat[256][2]``) and by (quant table,
context, state slot) (``rc_stat2[qidx][context][32][2]``).  The port
counts on the card, in the stats instances of K1 and K1-ext
(``tpu/rc_encode.py``); ``serialize_stats`` writes the reference's
stats_out text from the summed tables.

Pass 2 (``stats_in``) re-derives from that text:

  * a cost-sorted custom state-transition table (``sort_stt``,
    ffv1enc.c:621-667);
  * per-context tuned initial states (``build_initial_states``,
    ffv1enc.c:960-984) from ``find_best_state``'s table, a dynamic
    program over the adaptive state's evolution (ffv1enc.c:139-183).

``find_best_state`` launches csrc/find_best_state.cu on a CUDA device and
runs its plain version, ``find_best_state_ref``, on the CPU.  Both give
the reference's table bit for bit: they keep the C fold's order of
floating-point operations (see ``find_best_state_ref``).

Behavioral parity: ffv1enc.c:139-183, :621-667, :898-986, :1235-1279.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import tables as T
from ..kernels.build import count_launch, expect, load

# find_best_state kernel launches (read by chip_smoke.py)
LAUNCHES: dict = {}
# table bytes -> find_best_state's (256, 256) table
_BEST_STATE: dict = {}
# the candidate initial states j of a probability i: i - 10 .. i + 10
SPAN = 21


def serialize_stats(rc_stat, rc_stat2_list, gob_count: int) -> str:
    """The reference's stats_out text (ffv1enc.c:1261-1276): every count
    followed by a space, rc_stat's 256 pairs, then each quant table's
    (context, slot) pairs, then gob_count and a newline.  The reference's
    newline after the rc_stat block is overwritten by the next pair
    (its ``snprintf`` is not followed by ``p += strlen``), so it never
    appears; neither does it here."""
    flat = [np.asarray(rc_stat, np.uint64).ravel()] + \
        [np.asarray(st2, np.uint64).ravel() for st2 in rc_stat2_list]
    return "".join(f"{v} " for v in np.concatenate(flat).tolist()) + \
        f"{gob_count}\n"


def parse_stats(text: str, quant_table_count, context_counts):
    """Parse the stats text back (ffv1enc.c:906-954): (rc_stat uint64
    (256, 2), [rc_stat2 uint64 (cc_i, 32, 2) per quant table],
    gob_count)."""
    toks = text.split()
    need = 512 + 64 * sum(context_counts[i]
                          for i in range(quant_table_count)) + 1
    if len(toks) < need:
        raise ValueError("invalid 2-pass stats (truncated)")
    vals = np.array([int(t) for t in toks[:need]], dtype=np.uint64)
    rc_stat = vals[:512].reshape(256, 2).copy()
    pos = 512
    rc_stat2 = []
    for i in range(quant_table_count):
        n = context_counts[i] * 64
        rc_stat2.append(vals[pos:pos + n].reshape(context_counts[i], 32, 2)
                        .copy())
        pos += n
    gob_count = int(toks[pos])
    if gob_count <= 0:
        raise ValueError("invalid 2-pass stats (gob_count)")
    return rc_stat, rc_stat2, gob_count


def sort_stt(rc_stat: np.ndarray, stt: np.ndarray) -> bool:
    """Greedy cost-sorting of the state-transition table
    (ffv1enc.c:621-667).  Mutates rc_stat and stt in place."""
    def cost(old, new):
        # float(uint64) -> double is exact below 2**53; math.log2 is the
        # platform libm, matching the reference build's rounding
        return (float(rc_stat[old][0]) * -math.log2((256 - new) / 256.0) +
                float(rc_stat[old][1]) * -math.log2(new / 256.0))

    def cost2(old, new):
        return cost(old, new) + cost(256 - old, 256 - new)

    changed_any = False
    while True:
        changed = False
        for i in range(12, 244):
            for i2 in range(i + 1, min(245, i + 4)):
                size0 = cost2(i, i) + cost2(i2, i2)
                sizex = cost2(i, i2) + cost2(i2, i)
                if size0 - sizex > size0 * 1e-14 and i != 128 and i2 != 128:
                    stt[i], stt[i2] = stt[i2], stt[i]
                    rc_stat[[i, i2]] = rc_stat[[i2, i]]
                    if i != 256 - i2:
                        stt[256 - i], stt[256 - i2] = \
                            stt[256 - i2], stt[256 - i]
                        rc_stat[[256 - i, 256 - i2]] = \
                            rc_stat[[256 - i2, 256 - i]]
                    for j in range(1, 256):
                        if stt[j] == i:
                            stt[j] = i2
                        elif stt[j] == i2:
                            stt[j] = i
                        if i != 256 - i2:
                            if stt[256 - j] == 256 - i:
                                stt[256 - j] = 256 - i2
                            elif stt[256 - j] == 256 - i2:
                                stt[256 - j] = 256 - i
                    changed = changed_any = True
        if not changed:
            break
    return changed_any


def l2tab() -> np.ndarray:
    """float64 (256,): log2(m / 256) for m = 1..255 (0 at m = 0), from
    the platform libm (``math.log2``), as the C build computes it."""
    tab = np.zeros(256)
    tab[1:] = [math.log2(m / 256.0) for m in range(1, 256)]
    return tab


def find_best_state_ref(one_state, i_values=range(256), count=False):
    """Plain version of find_best_state (ffv1enc.c:139-183): uint8
    (len(i_values), 256), row r the best initial state for a one-bit
    probability of i_values[r] / 256 after each count k = 0..255.  With
    ``count``, (that table, the number of terms folded: the (k, m) of
    each (i, j) row with occ[m] != 0, which the C computes and the
    kernel counts in ``find_best_state_terms``).

    The C fold runs per candidate row (i, j): occ, a distribution over
    the states, starts at state j; each step k adds to len the expected
    cost of one bit, sum over m of occ[m] * (p * l2tab[m] + (1 - p) *
    l2tab[256 - m]) in the order m = 1..255, and moves occ one bit on.
    The result is bit for bit the C fold's, because every operation is
    the same IEEE double operation in the same order:

      * vectorised across the (i, j) rows only; m and k stay loops in the
        C order (the sum over m is a sequential fold, never a pairwise
        reduction);
      * a term whose occ[m] is 0 is added as a signed zero, which leaves
        len and nocc unchanged, so the C's skip of those terms needs no
        mask;
      * the scatter nocc[one_state[m]] += occ[m] * p, nocc[256 -
        one_state[256 - m]] += occ[m] * (1 - p) runs in rounds: round r
        adds the r-th contribution, in the C order, of every target at
        once (each target at most once a round);
      * nocc is 257 wide: one_state[256 - m] = 0 reaches index 256,
        which the C writes past its array; that column is dropped;
      * the pick over j is the first strict minimum, as the C's
        ``len < best_len[k]`` over ascending j.
    """
    one = np.asarray(one_state, dtype=np.int64)
    l2 = l2tab()
    i_values = list(i_values)
    rows = [(i, j) for i in i_values
            for j in range(max(i - 10, 1), min(i + 11, 256)) if one[j]]
    best = np.zeros((len(i_values), 256), np.uint8)
    terms = 0
    if not rows:
        return (best, terms) if count else best
    R = len(rows)
    p = np.array([i / 256.0 for i, _j in rows])
    q = 1 - p
    # cvec[m - 1] = p * l2tab[m] + (1 - p) * l2tab[256 - m], m = 1..255
    cvec = p[None, :] * l2[1:, None] + q[None, :] * l2[:0:-1, None]
    # the scatter's rounds: per round (targets, sources) with each target
    # once; a source indexes [occ * p; occ * (1 - p)] over m = 1..255
    order = []
    for m in range(1, 256):
        order += [(int(one[m]), m - 1), (256 - int(one[256 - m]), 254 + m)]
    seen: dict = {}
    rounds: list = []
    for tgt, src in order:
        r = seen.get(tgt, 0)
        seen[tgt] = r + 1
        if r == len(rounds):
            rounds.append(([], []))
        rounds[r][0].append(tgt)
        rounds[r][1].append(src)
    rounds = [(np.array(t), np.array(s)) for t, s in rounds]

    occ = np.zeros((257, R))
    occ[[j for _i, j in rows], np.arange(R)] = 1.0
    length = np.zeros(R)
    lens = np.empty((256, R))
    for k in range(256):
        if count:
            terms += int(np.count_nonzero(occ[1:256]))
        folded = occ[1:256] * cvec
        for m in range(255):
            length -= folded[m]
        lens[k] = length
        prod = np.concatenate([occ[1:256] * p, occ[1:256] * q])
        nocc = np.zeros((257, R))
        for tgt, src in rounds:
            nocc[tgt] += prod[src]
        occ = nocc
    for r, i in enumerate(i_values):
        mine = [n for n, (ri, _j) in enumerate(rows) if ri == i]
        if mine:
            pick = np.argmin(lens[:, mine], axis=1)
            best[r] = np.array([rows[mine[c]][1] for c in pick], np.uint8)
    return (best, terms) if count else best


def _launch(one_state: torch.Tensor, terms=None) -> torch.Tensor:
    """find_best_state's kernels (csrc/find_best_state.cu) on the current
    stream: uint8 (256,) on a CUDA device -> uint8 (256, 256).  With
    ``terms`` (a zeroed int64 (1,) tensor there) the fold adds the
    number of terms it folds to it."""
    dev = one_state.device
    expect("one_state", one_state, torch.uint8, (256,), dev)
    l2 = torch.from_numpy(l2tab()).to(dev)
    lens = torch.empty((256 * SPAN, 256), dtype=torch.float64, device=dev)
    best = torch.empty((256, 256), dtype=torch.uint8, device=dev)
    fn = load("find_best_state").find_best_state_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    with torch.cuda.device(dev):
        err = fn(one_state.data_ptr(), l2.data_ptr(), lens.data_ptr(),
                 best.data_ptr(), None if terms is None else
                 terms.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"find_best_state kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(LAUNCHES, "find_best_state")
    return best


def find_best_state_terms(one_state: torch.Tensor):
    """find_best_state's kernels on a CUDA tensor, counting: (the uint8
    (256, 256) table, the number of terms the fold folds, those (k, m) of
    each (i, j) row with occ[m] != 0), for the kernel's roofline bound."""
    terms = torch.zeros(1, dtype=torch.int64, device=one_state.device)
    best = _launch(one_state, terms)
    return best, int(terms.item())


def find_best_state_kernel(one_state) -> torch.Tensor:
    """find_best_state on the tensor's device: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU one; uint8 (256, 256) there."""
    dev = one_state.device
    if dev.type == "cpu":
        return torch.from_numpy(find_best_state_ref(one_state.numpy()))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(one_state)


def find_best_state(one_state, device) -> np.ndarray:
    """find_best_state's (256, 256) uint8 table for the state-transition
    table ``one_state`` (256,), computed on ``device`` and cached by the
    table's bytes (every pass-2 encoder of one statistics text asks for
    the same table; the kernel's table and the plain version's are the
    same bits)."""
    dev = torch.device(device)
    one = np.ascontiguousarray(one_state, dtype=np.uint8)
    key = one.tobytes()
    if key not in _BEST_STATE:
        _BEST_STATE[key] = find_best_state_kernel(
            torch.from_numpy(one).to(dev)).cpu().numpy()
    return _BEST_STATE[key].copy()


def _c_round(p: float) -> int:
    """C round(): half away from zero (Python round() is half-to-even)."""
    return math.floor(p + 0.5) if p >= 0 else math.ceil(p - 0.5)


def _clip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def build_initial_states(rc_stat2_list, gob_count, best_state,
                         context_counts):
    """Derive tuned per-context initial states (ffv1enc.c:960-984).

    The count index is av_clip_uint8((a+b)/gob_count): the double is
    truncated toward zero by the int conversion, THEN clipped.
    """
    out = []
    for i, st2 in enumerate(rc_stat2_list):
        cc = context_counts[i]
        init = np.full((cc, 32), 128, dtype=np.uint8)
        for k in range(32):
            a = 0.0
            b = 0.0
            jp = 0
            for j in range(cc):
                p = 128.0
                s0 = float(st2[j][k][0])
                s1 = float(st2[j][k][1])
                if (s0 + s1 > 200 and j) or a + b > 200:
                    if a + b:
                        p = 256.0 * b / (a + b)
                    init[jp][k] = best_state[
                        _clip(_c_round(p), 1, 255)][
                        _clip(int((a + b) / gob_count), 0, 255)]
                    jp += 1
                    while jp < j:
                        init[jp][k] = init[jp - 1][k]
                        jp += 1
                    a = b = 0.0
                a += s0
                b += s1
                if a + b:
                    p = 256.0 * b / (a + b)
                init[j][k] = best_state[
                    _clip(_c_round(p), 1, 255)][
                    _clip(int((a + b) / gob_count), 0, 255)]
        out.append(init)
    return out


def tuned_params(rp, stats_in: str, device) -> None:
    """Pass 2 on the resolved parameters ``rp``, in place, as the host
    encoder does it (codec/encoder.py:53-61 of the JAX package): the
    custom state-transition table sorted by the statistics' costs, and
    the tuned initial states of every quant table, which
    write_extradata then writes.  ``find_best_state`` runs on
    ``device``."""
    rc_stat, rc_stat2, gob = parse_stats(stats_in, rp.quant_table_count,
                                         rp.context_counts)
    if rp.ac == T.AC_RANGE_CUSTOM_TAB:
        sort_stt(rc_stat, rp.state_transition)
    best = find_best_state(rp.state_transition, device)
    rp.initial_states = build_initial_states(rc_stat2, gob, best,
                                             rp.context_counts)
