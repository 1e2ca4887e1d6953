"""Builds the port's CUDA kernels and binds them with ctypes.

Two kinds of library, both with a plain C interface (no PyTorch headers,
so a build takes seconds) and both landing in `_build/` beside this file:

- `build`: one `nvcc` call compiles the sources `csrc/*.cu` (K2
  `window_counts.cu`; K3-K5 and K25 `dense_rhs.cu`; K30
  `dense_vjp.cu`; K6 `dop853.cu`; K7
  and K8 `gather_rhs.cu`; K9 `world_mass.cu`; K10 `table_round.cu`; K12
  `pattern_scan.cu`; K13 `weighted_counts.cu`; K15 `bitplanes.cu`; K16
  and K18 `bff_round.cu`; K19-K22 `frontier.cu`; K26 `steady_aug.cu`;
  K27 `ssa_round.cu`; K28 `metropolis.cu`), which may include headers
  from `csrc/`, into one shared library, and links into it the objects
  that one `nvcc` call each has compiled first from `FMAD_SOURCES` (K29
  `dopri5_batch.cu`, whose math library must contract as PyTorch's);
- `build_unit`: one `nvcc` call compiles one generated translation unit,
  which includes headers from `csrc/` (K1 and K11, one library per
  decision machine, from `engine/k1_source.py`; K14, one library per
  bit-sliced circuit, from `engine/bitslice_source.py`; K17, one library
  per BFF circuit, from `engine/bff_bitslice_source.py`).

Each library is named by a hash of what goes into it (sources, included
templates, flags): a changed source builds anew, an unchanged one loads
the library already there. A new library is written under a temporary
name and renamed into place, so concurrent builds need no lock file.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_STEM = "libckpe_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Sources compiled apart, with contraction allowed, into objects that
# `build` links into the library. Their own arithmetic is written with
# the round-to-nearest intrinsics, which are never contracted, so the
# flag reaches only the CUDA math library inside them: its `pow` then has
# the bits of PyTorch's `pow` on the card, which under -fmad=false it
# does not for a few arguments in a million (measured on the H100).
FMAD_SOURCES = ("dopri5_batch.cu",)
OBJ_FLAGS = tuple(f for f in NVCC_FLAGS if f not in ("-fmad=false",
                                                     "-shared")) + (
    "-fmad=true", "-c")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(paths, text: str = "") -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + OBJ_FLAGS + FMAD_SOURCES)
                       .encode())
    h.update(text.encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where `build` puts the library: named by a hash of the sources,
    the headers `csrc/*.cuh` and the flags."""
    return BUILD_DIR / f"{LIB_STEM}-{_digest(sources() + headers())}.so"


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise FileNotFoundError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built")


def _compile(target: Path, inputs, extra=(),
             flags=NVCC_FLAGS) -> tuple[Path, str, float]:
    """One `nvcc` call from ``inputs`` into ``target`` unless it exists.
    Returns (target, nvcc's output with the `-Xptxas -v` resource lines,
    seconds spent; 0 when nothing was built)."""
    if target.exists():
        return target, "", 0.0
    compiler = nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, *extra, "-o", str(tmp), *map(str, inputs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target, proc.stdout + proc.stderr, seconds


def build() -> tuple[Path, str, float]:
    """Compiles `csrc/*.cu` unless the library for these sources is
    already built: each of `FMAD_SOURCES` into an object first, then one
    `nvcc` call for the rest that links those objects in; returns as
    `_compile` (the logs and seconds of both steps)."""
    target = library_path()
    if target.exists():
        return target, "", 0.0
    objs, logs, seconds = [], [], 0.0
    rest = []
    for src in sources():
        if src.name not in FMAD_SOURCES:
            rest.append(src)
            continue
        obj = target.with_name(f"{target.stem}-{src.stem}.o")
        _, log, sec = _compile(obj, [src], flags=OBJ_FLAGS)
        objs.append(obj)
        logs.append(log)
        seconds += sec
    _, log, sec = _compile(target, rest + objs)
    return target, "".join(logs) + log, seconds + sec


def unit_library_path(stem: str, source: str) -> Path:
    """Where `build_unit` puts the library of ``source``: named by a hash
    of the unit, the headers `csrc/*.cuh` and the flags."""
    digest = _digest(headers(), source)
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_unit(stem: str, source: str) -> tuple[Path, str, float]:
    """Compiles one generated translation unit ``source``, which may
    include the headers `csrc/*.cuh`, into `_build/lib{stem}-{hash}.so`
    unless it is already built; returns as `_compile`. The unit is kept
    beside the library as `{stem}-{hash}.cu`."""
    target = unit_library_path(stem, source)
    if target.exists():
        return target, "", 0.0
    nvcc()  # raises before any directory is made when there is none
    BUILD_DIR.mkdir(exist_ok=True)
    unit = target.with_name(f"{target.stem[3:]}.cu")
    tmp = unit.with_name(f"{unit.name}.{os.getpid()}.tmp")
    tmp.write_text(source)
    os.replace(tmp, unit)
    return _compile(target, [unit], ("-I", str(CSRC_DIR)))


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build()[0]))
    # ckpe_window_counts(tape, B, L, size_a, cl_k, counts, stream)
    lib.ckpe_window_counts.argtypes = [_P, ctypes.c_longlong, _I, _I, _I,
                                       _P, _P]
    lib.ckpe_window_counts.restype = _I
    # ckpe_pyramid(p, a, k, m, low, stream)
    lib.ckpe_pyramid.argtypes = [_P, _I, _I, _I, _P, _P]
    # ckpe_dense_sweep(items, phase_ptr, n_phases, max_phase, table, work,
    #                  dy, n, p, low, pair_num, pair_den, pair_const,
    #                  chain, csr_ptr, n_sig, s, a, k, form, blocks,
    #                  n_items, table_len, work_len, stream)
    k5 = [_P, _P, _I, _L, _P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _P, _I,
          _P, _I, _I, _I, _I, _I, _I, _L, _P]
    lib.ckpe_dense_sweep.argtypes = k5
    # ckpe_dense_rhs(tapes, m, <ckpe_dense_sweep's arguments>)
    lib.ckpe_dense_rhs.argtypes = [_I, _I] + k5
    # ckpe_dense_jvp(items, phase_ptr, n_phases, max_phase, table, work,
    #                jdy, dy, n, p, low, v, vlow, pair_num, pair_den,
    #                pair_const, chain, csr_ptr, n_sig, s, a, k, form,
    #                blocks, n_items, table_len, work_len, stream), and
    # ckpe_dense_jvp_rhs(tapes, m, levels_p, <the same>)
    k25 = k5[:7] + [_P] + k5[7:10] + [_P, _P] + k5[10:]
    lib.ckpe_dense_jvp.argtypes = k25
    lib.ckpe_dense_jvp_rhs.argtypes = [_I, _I, _I] + k25
    # ckpe_dense_vjp(tapes, levels_p, fwd, fwd_ptr, n_fwd, rv, rv_ptr, n_rv,
    #                table, steps, tab_ptr, tab_steps, sig_ptr, sig_terms,
    #                world_ptr, world_sigs, wt_pyr, wt_q, n_wt, w_num, w_den,
    #                w_const, chain, n_worlds, pair_num, pair_den,
    #                pair_const, csr_ptr, n_sig, n_xs, n_state, p, low, u,
    #                scratch, work_len, n_q, pbar, wbar, a, k, form, blocks,
    #                max_phase, stream)
    lib.ckpe_dense_vjp.argtypes = (
        [_I, _I, _P, _P, _I, _P, _P, _I] + [_P] * 10 + [_I, _P, _P, _P, _I,
                                                        _I]
        + [_P] * 4 + [_I, _I, _L] + [_P] * 4 + [_L, _L, _P, _P]
        + [_I] * 4 + [_L, _P])
    # ckpe_steady_aug(x, a, k, cons_w, n_c, c_norm, mode, f, cst, ww, mask,
    #                 keep, form, low, scratch, out, stream)
    lib.ckpe_steady_aug.argtypes = [_P, _I, _I, _P, _I, _D, _I, _P, _P, _P,
                                    _P, _P, _I, _P, _P, _P, _P]
    # ckpe_tree_rhs(p, low, n_state, a, k, pair_num, pair_den, pair_const,
    #               chain, csr_ptr, n_sig, s, dict_num, dict_den, n_dict,
    #               ratio, levels, n_levels, nv, ev, ent, tgt_ptr, n_tgt, dy,
    #               stream)
    head = [_P, _P, _L, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _L, _P]
    tail = [_P, _P, _P, _I, _P, _P]
    lib.ckpe_tree_rhs.argtypes = head + [_P, _I, _P] + tail
    # ckpe_chain_rhs(<the same head>, cols, n_cols, sig, sig_wide, n_ev,
    #                ev, ent, tgt_ptr, n_tgt, dy, stream)
    lib.ckpe_chain_rhs.argtypes = head + [_P, _I, _P, _I, _L] + tail
    # ckpe_gather_scatter(<the same tail>: ev, ent, tgt_ptr, n_tgt, dy,
    #                     stream)
    lib.ckpe_gather_scatter.argtypes = tail
    # ckpe_k6_tableau(count, rows, coefs, n_rows)
    lib.ckpe_k6_tableau.argtypes = [_P, _P, _P, _I]
    # ckpe_k6_stage(y, ks, ks_ld, n, which, swap, fsal, h, out, stream)
    lib.ckpe_k6_stage.argtypes = [_P, _P, _L, _L, _I, _I, _I, _D, _P, _P]
    # ckpe_k6_norms(mode, n, rtol, atol, h, y, y_new, f0, f1, ks, ks_ld,
    #               swap, fsal, e0, e1, scratch, stream)
    lib.ckpe_k6_norms.argtypes = [_I, _L, _D, _D, _D, _P, _P, _P, _P, _P, _L,
                                  _I, _I, _I, _I, _P, _P]
    # ckpe_k6_resid(z, g, f, hg, n, out, stream)
    lib.ckpe_k6_resid.argtypes = [_P, _P, _P, _D, _L, _P, _P]
    # ckpe_k6_dense_coeffs(y, y_new, f_old, f_new, ks, ks_ld, n, h, rows,
    #                      coefs, nu, out, f_ld, stream)
    lib.ckpe_k6_dense_coeffs.argtypes = [_P, _P, _P, _P, _P, _L, _L, _D,
                                         _P, _P, _I, _P, _L, _P]
    # ckpe_k6_dense_eval(F, f_ld, y, n, ts, i_out, m, t, h, out, out_ld,
    #                    stream)
    lib.ckpe_k6_dense_eval.argtypes = [_P, _L, _P, _L, _P, _L, _I, _D, _D,
                                       _P, _L, _P]
    # ckpe_world_mass(p, low, n_state, n_low, num, den, m_const, chain,
    #                 n_worlds, scratch, out, stream)
    lib.ckpe_world_mass.argtypes = [_P, _P, _L, _L, _P, _P, _P, _I, _I, _P,
                                    _P, _P]
    # ckpe_table_rounds(p, d, u, u_f64, shifts, per_member, k0, n, B, L,
    #                   E, p_lo, n_p, d_lo, n_d, pv, out_cum, out_world,
    #                   rows, M, wr_mask, wr_val, tile, threads, stream)
    lib.ckpe_table_rounds.argtypes = [_P, _P, _P, _I, _P] + [_I] * 10 + [
        _P, _P, _P, _I, _I, _P, _P, _I, _I, _P]
    # ckpe_pattern_scan(tape, elem, B, L, pattern, P, mode, out, t_hit,
    #                   t_now, members, stream)
    lib.ckpe_pattern_scan.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P, _P,
                                      _P, _I, _P]
    # ckpe_weighted_counts(tape, w, B, L, size_a, cl_k, per, partial, hist,
    #                      ticket, out, stream)
    lib.ckpe_weighted_counts.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                                         _P, _P, _P]
    # ckpe_bitplanes_pack(sym, elem, sb, se, sc, B, E, stride, inner_c, nb,
    #                     transpose, out, stream), and _unpack alike
    k15 = [_P, _I, _L, _L, _L, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.ckpe_bitplanes_pack.argtypes = k15
    lib.ckpe_bitplanes_unpack.argtypes = k15
    # ckpe_bff_rounds(params, p, d, prov, shifts, per_member, k0, n, B, L,
    #                 E, totals, u, vals, rate, stream)
    lib.ckpe_bff_rounds.argtypes = [_P, _P, _P, _P, _P] + [_I] * 6 + [
        _P, _P, _P, _D, _P]
    # ckpe_bff_mutate(tape, prov, u, vals, rate, count, stream)
    lib.ckpe_bff_mutate.argtypes = [_P, _P, _P, _P, _D, _L, _P]
    # ckpe_content_hash(p, d, flag, K, L, stride, bits, out, stream)
    lib.ckpe_content_hash.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P]
    # ckpe_merge_resample(mode, hs, perm, lw, u, log_k, K, parent, new_lw,
    #                     n_groups, fscr, iscr, lscr, stream)
    lib.ckpe_merge_resample.argtypes = [_I, _P, _P, _P, _P, _D, _L, _P, _P,
                                        _P, _P, _P, _P, _P]
    # ckpe_gather_pair(p, d, parent, K, L, out_p, out_d, flag, out_flag,
    #                  stream)
    lib.ckpe_gather_pair.argtypes = [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P]
    # ckpe_k22_workspace_bytes(K, M)
    lib.ckpe_k22_workspace_bytes.argtypes = [_L, _I]
    lib.ckpe_k22_workspace_bytes.restype = _L
    # ckpe_k22_rank(p, d, lw, site, K, L, p_lo, n_p, d_lo, n_d, rows, M,
    #               pv, out_log, out_world, wr_mask, wr_val, rows_out,
    #               child, ws, new_lw, stream)
    lib.ckpe_k22_rank.argtypes = [_P] * 4 + [_I] * 8 + [_P] * 10
    # ckpe_k22_keep(p, d, out_p, out_d, rows, child, site, K, L, p_lo,
    #               n_p, d_lo, n_d, rows, M, pv, out_log, out_world,
    #               wr_mask, wr_val, ws, new_lw, stream)
    lib.ckpe_k22_keep.argtypes = [_P] * 7 + [_I] * 8 + [_P] * 8
    # ckpe_ssa_rounds(order, stoich, rates, R, S, net_buf, is_double, u, B,
    #                 E, t_state, n_state, t_out, n_out, stream)
    lib.ckpe_ssa_net_bytes.argtypes = []
    lib.ckpe_ssa_net_bytes.restype = _I
    lib.ckpe_ssa_rounds.argtypes = [_P, _P, _P, _I, _I, _P, _I, _P, _L, _I,
                                    _P, _P, _P, _P, _P]
    # ckpe_ssa_rounds_wide(fac_lo, fac_s, fac_j, stoich, rates, R, S,
    #                      is_double, u, B, E, t_state, n_state, t_out,
    #                      n_out, stream)
    lib.ckpe_ssa_rounds_wide.argtypes = [_P] * 5 + [_I, _I, _I, _P, _L, _I,
                                                    _P, _P, _P, _P, _P]
    # ckpe_metropolis(T, N, rounds, rs, thr, chains, sites, u, steps,
    #                 count_first, counts, stream)
    lib.ckpe_metropolis.argtypes = [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                                    _P, _P]
    # ckpe_metropolis_bytes(N, rounds, rs)
    lib.ckpe_metropolis_bytes.argtypes = [_I, _I, _I]
    lib.ckpe_metropolis_bytes.restype = _L
    # ckpe_dopri5_batch(coef, has, B, y0, params, ts, n_out, rtol, atol,
    #                   max_steps, ys, n_acc, n_rej, stream)
    lib.ckpe_dopri5_batch.argtypes = [_P, _P, _I, _P, _P, _P, _I, _D, _D, _L,
                                      _P, _P, _P, _P]
    for name in ("ckpe_table_rounds", "ckpe_pattern_scan",
                 "ckpe_ssa_rounds", "ckpe_ssa_rounds_wide", "ckpe_metropolis", "ckpe_dopri5_batch",
                 "ckpe_bitplanes_pack", "ckpe_bitplanes_unpack",
                 "ckpe_weighted_counts", "ckpe_bff_rounds", "ckpe_bff_mutate",
                 "ckpe_content_hash", "ckpe_merge_resample",
                 "ckpe_gather_pair", "ckpe_k22_rank", "ckpe_k22_keep",
                 "ckpe_pyramid", "ckpe_dense_sweep", "ckpe_dense_rhs",
                 "ckpe_dense_jvp", "ckpe_dense_jvp_rhs", "ckpe_dense_vjp",
                 "ckpe_steady_aug",
                 "ckpe_k6_resid",
                 "ckpe_world_mass",
                 "ckpe_tree_rhs", "ckpe_chain_rhs", "ckpe_gather_scatter",
                 "ckpe_k6_tableau", "ckpe_k6_stage", "ckpe_k6_norms",
                 "ckpe_k6_dense_coeffs", "ckpe_k6_dense_eval"):
        getattr(lib, name).restype = _I
    lib.ckpe_error_string.argtypes = [_I]
    lib.ckpe_error_string.restype = ctypes.c_char_p
    return lib


def block_order_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of a float64 vector ``v`` in the order the reductions of K6
    (`norms`) and K9 (`world_mass`) take it: at most 1,024 blocks of 256
    threads, thread t of block b adding elements b*256 + t +
    q*stride in turn from 0, each block's tree (the upper half added to
    the lower, halving), then thread t adding partials t, t + 256, ...
    from 0, and one more tree. (Padding adds exact zeros to sums that
    start at +0.0, which leaves their bits as they are.)"""
    n = v.numel()
    blocks = min(max(-(-n // 256), 1), 1024)

    def threads(x, width):  # [width] sums, each over x[t + q*width]
        pad = x.new_zeros(-(-x.numel() // width) * width)
        pad[:x.numel()] = x
        acc = x.new_zeros(width)
        for row in pad.view(-1, width):
            acc = acc + row
        return acc

    def tree(x):  # [rows, 256] -> [rows]
        w = 128
        while w:
            x = x[:, :w] + x[:, w:2 * w]
            w //= 2
        return x[:, 0]

    partials = tree(threads(v, blocks * 256).view(blocks, 256))
    return tree(threads(partials, 256).view(1, 256))[0]


def on_card(tensor, name: str) -> bool:
    """True for a CUDA tensor (the wrapper ``name`` launches its kernel),
    False for a CPU one (it runs its plain version); raises for any
    other device."""
    if tensor.device.type == "cpu":
        return False
    if tensor.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{tensor.device}")
    return True


def stream(tensor) -> int:
    """The current CUDA stream of ``tensor``'s card, as an int."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def check(rc: int, name: str, lib: ctypes.CDLL) -> None:
    """Raises when a C entry point of ``lib`` reported a CUDA error."""
    if rc:
        msg = lib.ckpe_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
