"""K1's and K11's machine-specific source: the decision machine compiled
into code.

:func:`k1_source` writes one CUDA translation unit for a
:class:`~.ensemble.DeviceMachine` from the level plan that the plain
walk (`ensemble._walk_plain`, `ensemble._writes_plain`) reads. Every
level, cell group, next-state table, choose threshold and write spec
becomes an immediate, as the Pallas probes unroll the machine at trace
time (`probes/pallas_plane_round.py:49`). The unit includes the
hand-written template `csrc/plane_round.cuh` (loads, stores, sites per
thread, launch loop), which documents the kernel's design, and at its
end `csrc/lattice_round.cuh`, K11's rolled round over the same walk and
writes, and `csrc/thermo_round.cuh`, K23's and K24's rounds (K11's with
the entropy ledgers of `ops/thermo.py`).

Two walks are written. The lane walk steps a thread's four sites at
once, one byte lane each of a 32-bit word: a level's next state is an
8-entry byte-table lookup (`prmt`) per chunk of its (node, branch)
table, chunks picked by lane masks; it is right whenever every window
symbol lies in [0, size_a). The exact walk takes one site at a time and
reads the reference's packed words with the reference's rule for
indices outside them (floored word index, word 0 out of range); the
template takes it for any thread that sees another symbol. The writes
are lane lookups over the write specs.

:func:`k1_library` builds the unit with `cuda.build_unit` (one `nvcc`
call per machine, cached on disk by a hash of the source, the template
and the flags) and loads it once per process.
"""

from __future__ import annotations

import ctypes
import functools

from .. import cuda
from . import ensemble as ens

# Indices the exact walk sees are >= -128 (an int8 symbol); the bias
# keeps the floored word index a division of non-negative ints.
_MIN_INDEX = -128


def _hex(x: float) -> str:
    return float(x).hex()


def _literal(value: int) -> str:
    return f"0x{value:x}u"


def _unpacked(words, bits):
    """Every field of little-endian packed ``words``, in order."""
    per = 31 // bits
    return [(w >> (bits * f)) & ((1 << bits) - 1)
            for w in words for f in range(per)]


def _field_fn(name: str, words, bits: int) -> list[str]:
    """``int name(int idx)``: field ``idx`` of the reference's packed
    ``words`` by the reference's rule (`ensemble._unpack_field`: floored
    word index, word 0 when it is out of range)."""
    per = 31 // bits
    bias = per * -(_MIN_INDEX // per)
    out = [f"K1_FN int {name}(int idx) {{",
           f"  const int r = (idx + {bias}) % {per};",
           f"  uint32_t w = {_literal(words[0])};"]
    if len(words) > 1:
        out.append(f"  const int q = (idx + {bias}) / {per} - {bias // per};")
        out += [f"  if (q == {wi}) w = {_literal(x)};"
                for wi, x in enumerate(words) if wi]
    out += [f"  return (int)((w >> ({bits} * r)) & {(1 << bits) - 1}u);",
            "}"]
    return out


def _lane_lookup(var: str, idx: str, table, indent: str) -> list[str]:
    """Sets ``var`` to lane-wise ``table[idx]`` (bytes, at most 128
    entries; every lane of ``idx`` indexes the table): one `prmt` per
    chunk of 8 entries, the chunk picked by a lane mask."""
    padded = list(table) + [0] * (-len(table) % 8)
    words = [_literal(sum(int(v) << (8 * i)
                          for i, v in enumerate(padded[w * 4:w * 4 + 4])))
             for w in range(len(padded) // 4)]
    out = [f"{indent}{{",
           f"{indent}  const uint32_t sel = k1_selector({idx});",
           f"{indent}  {var} = k1_prmt({words[0]}, {words[1]}, sel);"]
    for c in range(1, len(padded) // 8):
        out.append(f"{indent}  {{ const uint32_t m = k1_lanes_ge({idx}, "
                   f"{8 * c}); {var} = ({var} & ~m) | (k1_prmt("
                   f"{words[2 * c]}, {words[2 * c + 1]}, sel) & m); }}")
    out.append(f"{indent}}}")
    return out


def _choose_fn(li: int, groups, S: int, logp: bool) -> list[str]:
    """``bool k1_choose_l{li}(int v, double& u, int& b)``: the choose
    groups of level ``li`` as `ensemble._walk_plain` computes them. The
    group holding state ``v`` picks branch ``b`` from ``u``, and ``u`` is
    renormalised into it, in float64 (or by one float32 division where
    the reference's uniform is still float32); false when no group holds
    ``v``. The groups only pick constants; the one division comes after
    them. With ``logp`` (a tempered walk) the function takes ``float&
    lp`` too and adds the branch's float32 increment to it."""
    f32 = any(g.f32_div for g in groups)
    lp_arg = ", float& lp" if logp else ""
    out = [f"K1_FN bool k1_choose_l{li}(int v, double& u, int& b{lp_arg}) {{",
           "  bool hit = false;",
           "  int bb = 0;",
           "  double lo = 0.0, wd = 1.0;"]
    if logp:
        out.append("  float dl = 0.0f;")
    if f32:
        out.append("  bool f32 = false;")

    def dl(g, j):  # the float32 increment, as an exact literal
        return f" dl = (float){_hex(g.deltas[j])};" if logp else ""

    for g in groups:
        out.append(f"  if (v >= {S + g.id_lo} && v <= {S + g.id_hi}) {{")
        out.append("    hit = true;")
        if f32:
            out.append(f"    f32 = {str(g.f32_div).lower()};")
        out.append(f"    bb = 0; lo = 0.0; wd = {_hex(g.widths[0])};"
                   + dl(g, 0))
        for j in range(1, len(g.widths)):
            c = _hex(g.cum[j - 1])
            out.append(f"    if (u >= {c}) {{ bb = {j}; lo = {c}; "
                       f"wd = {_hex(g.widths[j])};{dl(g, j)} }}")
        out.append("  }")
    div = "K1_DDIV(K1_DSUB(u, lo), wd)"
    if f32:
        div = f"f32 ? (double)K1_FDIV((float)u, (float)wd) : {div}"
    out += ["  if (hit) {",
            "    b = bb;",
            f"    u = {div};"]
    if logp:
        out.append("    lp = lp + dl;")
    out += ["  }",
            "  return hit;",
            "}"]
    return out


def _walk_exact(levels, groups, S: int, logp: bool) -> list[str]:
    """`ensemble._walk_plain` for one site, one block of code a level:
    live states are S + local id, terminal ones (< S) the write spec.
    With ``logp`` the walk is ``k1_walk_exact_logp(c, u, lp)``, which
    adds the path's float32 increments to ``*lp`` level by level, and
    ``k1_walk_exact`` calls it with a scratch sum."""
    if logp:
        out = ["K1_FN int k1_walk_exact_logp(const int* c, double u, "
               "float* lp) {"]
    else:
        out = ["K1_FN int k1_walk_exact(const int* c, double u) {"]
    out += [f"  int v = {S};",
            "  int b;",
            "  (void)u;"]
    for li, (lv, grp) in enumerate(zip(levels, groups)):
        if lv.cell_groups:
            out.append(f"  b = c[{lv.cell_groups[0][0]}];")
            out += [f"  b = v >= {S + lo} ? c[{cell}] : b;"
                    for cell, lo in lv.cell_groups[1:]]
        else:
            out.append("  b = 0;")
        if grp:
            lp = ", *lp" if logp else ""
            out.append(f"  {{ int bb; if (k1_choose_l{li}(v, u, bb{lp})) "
                       "b = bb; }")
        out += [f"  if (v >= {S}) v = k1_l{li}_exact((v - {S}) * "
                f"{lv.max_deg} + b);"]
    out += ["  return v;", "}"]
    if logp:
        out += ["K1_FN int k1_walk_exact(const int* c, double u) {",
                "  float lp = 0.0f;",
                "  return k1_walk_exact_logp(c, u, &lp);", "}"]
    return out


def _walk_lanes(levels, groups, S: int, logp: bool) -> list[str]:
    """The walk of four sites at once, one byte lane each: per level the
    branch lanes (cell groups by lane masks, choose nodes site by site),
    then the next state of every live lane by a lane lookup in the
    level's (node, branch) table. With ``logp`` the walk is
    ``k1_walk_lanes_logp(x, u, lp)``, which adds each lane's float32
    increments to ``lp[j]`` level by level, as `k1_walk_exact_logp` does
    for one site, and ``k1_walk_lanes`` calls it with scratch sums."""
    if logp:
        head = ("K1_FN uint32_t k1_walk_lanes_logp(const uint32_t* x, "
                "double* u, float* lp) {")
    else:
        head = "K1_FN uint32_t k1_walk_lanes(const uint32_t* x, double* u) {"
    out = [head,
           f"  uint32_t v = {S}u * 0x01010101u;",
           "  uint32_t b, r;",
           "  (void)u;"]
    for li, (lv, grp) in enumerate(zip(levels, groups)):
        out.append(f"  // level {li}: {lv.n_nodes} live nodes")
        if lv.cell_groups:
            out.append(f"  b = x[{lv.cell_groups[0][0]}];")
            out += [f"  {{ const uint32_t m = k1_lanes_ge(v, {S + lo}); "
                    f"b = (b & ~m) | (x[{cell}] & m); }}"
                    for cell, lo in lv.cell_groups[1:]]
        else:
            out.append("  b = 0;")
        if grp:
            lp = ", lp[j]" if logp else ""
            out += ["#pragma unroll",
                    "  for (int j = 0; j < 4; ++j) {",
                    "    int bb;",
                    f"    if (k1_choose_l{li}((v >> (8 * j)) & 0xff, u[j], "
                    f"bb{lp}))",
                    "      b = (b & ~(0xffu << (8 * j))) | ((uint32_t)bb << "
                    "(8 * j));",
                    "  }"]
        fields = _unpacked(lv.trans_words, lv.bits)
        table = fields[:lv.n_nodes * lv.max_deg]
        out += ["  {",
                f"    const uint32_t t = (v | 0x80808080u) - {S}u * "
                "0x01010101u;",
                "    const uint32_t live = k1_lane_mask(t);",
                f"    const uint32_t idx = (t & 0x7f7f7f7fu & live) * "
                f"{lv.max_deg}u + b;"]
        out += _lane_lookup("r", "idx", table, "    ")
        out += ["    v = (v & ~live) | (r & live);", "  }"]
    out += ["  return v;", "}"]
    if logp:
        out += ["K1_FN uint32_t k1_walk_lanes(const uint32_t* x, double* u) {",
                "  float lp[4] = {0.0f, 0.0f, 0.0f, 0.0f};",
                "  return k1_walk_lanes_logp(x, u, lp);", "}"]
    return out


def _writes(dm) -> list[str]:
    """Per window cell: the new symbol of each lane from its spec (the
    fields of `dm.wr_words`, as one lane lookup over the specs with
    0x80 for a spec that leaves the cell alone). The walk's spec is
    always below `num_specs`."""
    sym_bits = dm.wr_bits - 1
    written, cases = [], []
    for k, fields in enumerate(_spec_fields(dm)):
        if not any(f >> sym_bits for f in fields):
            continue
        written.append(k)
        table = [f & ((1 << sym_bits) - 1) if f >> sym_bits else 0x80
                 for f in fields]
        cases.append(f"    case {k}: {{")
        cases += ["      uint32_t r;"] + _lane_lookup("r", "spec", table,
                                                      "      ")
        cases += ["      const uint32_t keep = k1_lane_mask(r);",
                  "      return (r & ~keep) | (x & keep);",
                  "    }"]
    written_expr = " || ".join(f"k == {k}" for k in written) or "false"
    return [
        "K1_FN bool k1_written(int k) {",
        f"  return {written_expr};", "}",
        "K1_FN uint32_t k1_write_lanes(int k, uint32_t spec, uint32_t x) {",
        "  switch (k) {"] + cases + [
        "    default: return x;", "  }", "}"]


def _spec_fields(dm) -> list[list[int]]:
    """Per window cell, its field of each write spec (`dm.wr_words`):
    the top bit says the spec writes the cell, the rest is the symbol."""
    return [_unpacked(words, dm.wr_bits)[:dm.num_specs]
            for words in dm.wr_words]


def cell_traffic(dm: ens.DeviceMachine) -> tuple[list[int], list[int]]:
    """The window cells a round must read and those it must write: it
    reads the cells the walk reveals and the written cells that some
    spec leaves alone, and writes the cells that some spec writes."""
    sym_bits = dm.wr_bits - 1
    read = {cell for lv in ens._level_plan(dm) for cell, _ in lv.cell_groups}
    written = []
    for k, fields in enumerate(_spec_fields(dm)):
        hits = [f >> sym_bits for f in fields]
        if any(hits):
            written.append(k)
            if not all(hits):
                read.add(k)
    return sorted(read), written


def _check_lanes(dm, levels) -> None:
    """The lane walk keeps states, symbols and table indices below 128."""
    top = dm.num_specs + max(lv.n_nodes for lv in levels)
    widest = max(lv.n_nodes * lv.max_deg for lv in levels)
    if top > 128 or widest > 128 or dm.size_a > 128:
        raise ValueError(
            f"{dm.tag}: K1 takes machines whose write specs and live "
            f"nodes of a level number at most 128 (here {top}), whose "
            f"levels have at most 128 (node, branch) pairs (here "
            f"{widest}) and at most 128 symbols (here {dm.size_a})")


def k1_source(dm: ens.DeviceMachine, tau: float = 1.0) -> str:
    """The CUDA translation unit of K1, K11, K23 and K24 for machine
    ``dm`` with chooses sampled from q ∝ p^tau (deterministic: the same
    machine and tau give the same text). A tempered unit (tau != 1, a
    machine with choose nodes) also walks with the importance increments
    (`K1_LOGP`: K11's `ckpe_k11_rounds_logp`)."""
    levels = ens._level_plan(dm)
    groups = ens._choose_plan(dm, tau)
    logp = tau != 1.0 and dm.has_choose
    _check_lanes(dm, levels)
    lines = [
        f"// K1 for decision machine {dm.tag!r}: generated by",
        "// chemical_kinetics_and_program_execution_torch/engine/k1_source.py",
        "// from the machine's level plan; the kernel is csrc/plane_round.cuh.",
        f"// {dm.n_cells} window cells, {len(levels)} levels, "
        f"{dm.num_specs} write specs.",
        *([f"// Chooses sampled from q ~ p^{tau!r}, with the increments."]
          if logp else []),
        f"#define K1_N_P {dm.n_p}",
        f"#define K1_N_D {dm.n_d}",
        f"#define K1_P_LO {dm.p_lo}",
        f"#define K1_D_LO {dm.d_lo}",
        f"#define K1_SIZE_A {dm.size_a}",
        f"#define K1_CHOOSE {int(dm.has_choose)}",
        *(["#define K1_LOGP 1"] if logp else []),
        '#include "plane_round.cuh"',
        "",
    ]
    for li, (lv, grp) in enumerate(zip(levels, groups)):
        lines += _field_fn(f"k1_l{li}_exact", lv.trans_words, lv.bits)
        if grp:
            lines += _choose_fn(li, grp, dm.num_specs, logp)
    lines += _walk_exact(levels, groups, dm.num_specs, logp)
    lines += _walk_lanes(levels, groups, dm.num_specs, logp)
    lines += _writes(dm)
    lines += ["", "// K11, the rolled round, over the same walk and writes.",
              '#include "lattice_round.cuh"',
              "// K23 and K24, K11's round with the entropy ledgers.",
              '#include "thermo_round.cuh"']
    return "\n".join(lines) + "\n"


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _load(source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda.build_unit("k1", source)[0]))
    # ckpe_k1_rounds(p_st, d_st, uniforms, shifts, k0, n, B, E, stride,
    #                stream)
    lib.ckpe_k1_rounds.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.ckpe_k1_rounds.restype = _I
    # ckpe_k11_rounds(p, d, uniforms, shifts, per_member, k0, n, B, L, E,
    #                 tile, threads, stream)
    lib.ckpe_k11_rounds.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_P]
    lib.ckpe_k11_rounds.restype = _I
    # ckpe_k11_first_passage(p, d, uniforms, shifts, k0, n, B, L, E,
    #                        data_tape, pattern, P, t_hit, times, scan,
    #                        tile, threads, stream)
    lib.ckpe_k11_first_passage.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _I, _P, _I, _P, _P, _P, _I,
                                           _I, _P]
    lib.ckpe_k11_first_passage.restype = _I
    # ckpe_k23_rounds(p, d, uniforms, shifts, per_member, k0, n, B, L, E,
    #                 sig_tab, irr_tab, S, sigma, n_irrev, tile, threads,
    #                 stage_tab, stream)
    lib.ckpe_k23_rounds.argtypes = [_P, _P, _P, _P] + [_I] * 6 + [
        _P, _P, _I, _P, _P, _I, _I, _I, _P]
    lib.ckpe_k23_rounds.restype = _I
    # ckpe_k24_rounds(p, d, uniforms, shifts, per_member, k0, n, B, L, E,
    #                 g_prog, g_data, beta_eff, S, sigma, counts, spec_sig,
    #                 tile, threads, stream)
    lib.ckpe_k24_rounds.argtypes = [_P, _P, _P, _P] + [_I] * 6 + [
        _P, _P, ctypes.c_double, _I, _P, _P, _P, _I, _I, _P]
    lib.ckpe_k24_rounds.restype = _I
    if "K1_LOGP 1" in source:
        # ckpe_k11_rounds_logp(p, d, uniforms, shifts, k0, n, B, L, E, lw,
        #                      tile, threads, stream)
        lib.ckpe_k11_rounds_logp.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _P, _I, _I, _P]
        lib.ckpe_k11_rounds_logp.restype = _I
    lib.ckpe_error_string.argtypes = [_I]
    lib.ckpe_error_string.restype = ctypes.c_char_p
    return lib


# Loaded libraries by machine identity and tau (the machine is kept alive
# beside its library): hashing a DeviceMachine walks all its fields,
# which costs the host more than a launch.
_by_machine: dict[tuple, tuple] = {}


def k1_library(dm: ens.DeviceMachine, tau: float = 1.0) -> ctypes.CDLL:
    """K1, K11, K23 and K24 for ``dm`` at sampling temperature ``tau``,
    built on first use and loaded once per process. Libraries are keyed by the
    generated source, so two machines share one only when their kernels
    are the same code."""
    key = (id(dm), float(tau))
    hit = _by_machine.get(key)
    if hit is None:
        hit = _by_machine[key] = (dm, _load(k1_source(dm, tau)))
    return hit[1]
