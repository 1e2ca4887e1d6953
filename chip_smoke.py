#!/usr/bin/env python3
"""Runs the PyTorch port's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

from the root of the repository. Needs one CUDA card, `nvcc` and
`nvidia-smi`; imports no jax and nothing of the JAX package. Exits
non-zero, printing no result, without a card or outside the repository.

Phases (each prints its wall time; every check raises on failure):

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit;
2. build: `nvcc` calls started together, one for `csrc/*.cu` (K2-K10,
   K12, K13, K15, K16, K18-K22, K25-K28, with K29's object compiled
   first: `cuda.FMAD_SOURCES`), one for the generated unit (K1 and K11) of each
   machine (phase 3's three, ex3 and the fuzz rule of phase 9), one
   for the generated K14 unit of each of ex5's, ex4's and ex2's
   bit-sliced circuits and one for the generated K17 unit of each of the
   BFF circuits of ex6-mini-bff, -self and -midi, and beside them the
   `g++` call of the C++ expander (`csrc/expander.cc`, a host library),
   and one for the tempered unit (tau 0.5) of ex2 and of ex4,
   each with its seconds and the `-Xptxas -v` register, shared-memory
   and spill lines;
3. main path: `run_ensemble(bitslice=False)` (the FSM plane path; the
   default route is phase 10's) at B=16384, L=4096, E=256 on
   ex5-msrtf-machine for 2,000 rounds, then `window_counts` at cl_k=3;
   K1 must launch exactly 2,000 times and the plain round never, K2
   once; per-round time and transitions/s of the process's first call
   (cold: PyTorch loads its own kernels on their first launch and the
   allocator takes the buffers from the card) and of the same call
   again (warm), which must give the same tapes; each kernel's time
   (CUDA events) beside its bound, its plain version and the library
   call, K2's on each tape of `card_timing.k2_tapes` (the main
   path's final tapes, uniform, constant, 15,625 and 16,384 bins); the
   host's cost a launch, by one `plane_round` call a round and by
   `run_rounds`' one call for all rounds;
4. kernels against their plain versions on the card, at full width:
   K1 on ex5-msrtf-machine, ex4-chemical-turing and
   ex2-ferromagnetic-chain, one round at every phase in [0, 16), planes
   bit-identical after each, at E=256 (the word path) and at E=255
   (the byte path, an E that is not a multiple of 4); K2 against its
   plain version and `torch.bincount` (on bins found apart from the
   port's), exactly equal, on each of those tapes, on one with symbols
   outside [0, size_a), at 65,536 bins (the histogram in device
   memory) and on rows of 4,095 symbols (loads a symbol a lane), the
   last three also timed;
5. end to end on a small input: explicit draws through the card and
   through the CPU's plain path give the same tapes and window counts;
6. the exact SPD closure (K3-K6, built in phase 2 into K2's library;
   K4 runs as phase 0 of K5's launch):
   the canary exactly equal to its golden list; dp/dt by the kernels
   against the plain version on the card (rtol 1e-12, atol 1e-14) on
   the 13 cases of the JAX package's `tests/test_engine.py:18-32` and on
   ex4 at cl_k 5-8 (43,046,721 states), K5's signature weights (its
   phase 0) equal to K4's plain version bit for bit on each; at each
   cl_k 5-8 the launches an RHS (counted, the grid form: 3, K3 2 and K5
   1; 1 in the block and cluster forms); from the
   plan, printed but kept out of the `kernels` line: K5's phases, its
   live element-steps against a dense sweep's and a model of its sector
   traffic; each of K3-K6 alone against its plain version (K3 and K5
   also run twice for the same bits; K4 timed as a K5 launch over a plan
   with no sweep phases; K6's stage at B's tableau row, its one-launch
   norms, dense_coeffs and a step's dense_eval each the plain version's
   bits and the same twice), and K3, K5 and the RHS
   on the card and as the host paces them beside their bounds and the
   RHS's floor (p read once, dy written once); the main path: ex4
   scenarios a and b at cl_k 5 solved to t=2000 (2,001 samples, rtol =
   atol = 1e-13) through `markov_tapes.ode_integrate_ivp(backend=
   "torch")`, K5 and K6 each launched (K3 in the grid form) and no
   plain version called,
   the eight observables at t=2000 equal to the reference's oracles to
   rel 2e-6; the same two solves at cl_k 6 (531,441 states) within rel
   0.05, abs 1e-9 of cl_k 5; each solve's seconds, steps, RHS calls a
   second and K6's launches by function (`dense_eval` once an accepted
   step that holds samples) with the host's microseconds a launch
   inside each wrapper; the RHS also written into a padded stage row,
   into a row at a stride of n and copied in; each kernel's time beside
   its bound, its plain version, the library call where one exists, and
   the host's cost a launch; `dense_eval` also at each cl_k 5 solve's
   mean samples a step;
7. the gather engine, dual SPDs and chunked solves: ex4 at cl_k 5
   compiled through `compile_problem` (the C++ expander; its seconds,
   events, tree nodes); the compact tables' build seconds and bytes on
   the card beside the flat tables' (an int32 num, den and parent a
   node, 8-byte entries), each tree level's and chain column's
   dictionary size and id width; dp/dt by K7 (the prefix tree) and K8
   (the chains) equal to their plain versions on the card bit for bit,
   twice the same bits, with 16-bit ids and with every id 32 bits (the
   same dy), and within rtol 1e-12, atol 1e-14 of the dense RHS
   (K3-K5), on p0 and on a random SPD with p[0] = -1e-13; their
   launches an RHS (2), counted, no plain version called; each
   kernel's time beside its byte bound over the compact tables and
   over the flat ones and its plain version, the scatter stage alone
   against `index_add_` of the same signed terms, the RHS against the
   dense one; the main paths: ex4 scenario a solved at cl_k 5 through
   `build_dy_dt(engine="tree")` and through the chain engine,
   each within 2e-6 rel of the oracle, with its steps and its gap to
   phase 6's dense solve; the dense dual solves of
   `examples/ex3_dual_tape.py` (both soups) and
   `examples/ex4_dual_fuel.py` (pf 0.04) within 1e-10 abs of their
   committed trajectories (K3 launched once a tape an RHS); at ex4 cl_k
   5 (2 x 59,049 states) the dense dual RHS equal to the tree dual RHS
   and, at p_prog = p_data, its halves' sum to the shared RHS; ex4
   scenario b at cl_k 5 in chunks of 200 samples with a checkpoint
   under chiprun_out/ equal to the one-call solve (rtol 1e-9, atol
   1e-11), the checkpoint's files removed;
8. loose-tolerance solves and pruned exact mode (K6's dopri5 rows, K9
   `world_mass`): the main paths, each with every count set to 0 just
   before and read just after, no plain version called, K6's launches
   as the step counts say: (a) ex3var2 at cl_k 8 (65,536 states, 101
   samples to t=200) and (b) ex3 at cl_k 6 (1,001 samples to t=1000)
   through `markov_tapes.ode_integrate(backend="torch")` at rtol = atol =
   1e-9, default routing (dopri5), within 1e-10 abs of
   examples/ex3_var2_k8.npz and ex3_k6.npz; (c) the exact side of
   examples/ex6_bff_self_spd.py (ex6-mini-bff-self pruned at 1e-7: 4,517
   live worlds of 9,912, its RK4 through `make_dense_dy_dt(with_mass=
   True)`), mass and cls_spd within 1e-11 abs of the artifact; (d)
   examples/ex6_mini_bff.py's ten re-pruned dopri5 segments, each
   segment's kept worlds and the final mass (abs 1e-10) equal to the
   JAX package's CPU run; (e) ex4 scenario a at cl_k 5 by the
   step-clamped DOP853 (``dop853-step``) at 1e-13, within 2e-6 rel of
   the oracle, its steps beside the dense stepper's 29; each path's
   seconds, steps, RHS calls and K6's launches by function. K6's dopri5
   rows (every row, both swap states) and its error sum at 65,536 states
   and K9 on the ex6-self program (p0 and a random SPD) and on ex5 at
   threshold 1e-30 (mass 1) equal their plain versions bit for bit,
   twice; ex6-self's dp/dt by K3 and K5 (417 phases) against the plain
   version; the B5 stage and the error sum timed beside their bounds,
   plain versions and, for the stage, `torch.addmv`; K9 beside its bound
   and plain version;
9. the rolled lattice rounds (K10-K13) against exact answers, each path
   with every count set to 0 just before and read just after, no plain
   version called: (a) `run_ensemble` with ex5's transition table at
   B=16384, L=4096, E=256 for 200 rounds (K10 resident: its float64
   draws in chunks of `ensemble._TABLE_CHUNK`, 32 rounds, a launch a
   chunk, 7 launches), one round at
   explicit draws equal to `table_round_plain`, K10's tapes equal to
   K11's on ex5's machine at float32-exact uniforms (shared and
   per-member shifts), and, where the uniforms choose the outcome, one
   round on ex4's table (float64, 3 outcomes a row) and ex3's (float32,
   2) equal to `table_round_plain`; (b) the ex5 machine with independent
   sites (K11's resident rounds: one launch for the 200 rounds), one
   round at per-member shifts equal to the reference's delta-rolled loop
   written out (`independent_rounds_rolled_plain`); (c) ex4 at E=32
   (stride 128) for 200 rounds (one K11 launch a chunk of uniforms), K11
   equal to its plain
   version at shifts 0, 5, 127 and 4095; (d) the master-equation gates
   of the JAX package's tests/test_master.py at their settings, the
   port's `engine/master.py` the oracle: :75 (z < 6; on K1 with
   `bitslice=False`, the default route being phase 10's), :248 seed 0,
   :323 seed 702 through its transition table, :396 (total variation
   < 0.05), :441 and :497 (first passage, z < 6); (e) the ensemble side
   of examples/ex2_master_oracle.py (every snapshot within z < 6 of the
   master equation), and examples/ex2_first_passage.py's and
   ex4_ignition.py's first-passage runs on 12 and 8 generator seeds:
   each committed artifact's hit fraction and quartiles within z < 6 of
   the seeds' mean on the seeds' own scatter (`artifact_z`: one run's
   members share each round's sites, so they are not independent draws;
   seeds are), ex4's pooled survival within 0.02 of its closed form;
   on the card at those two runs' geometry, `first_passage_from_draws`
   (K11's resident rounds with K12's update in shared memory, one K11
   launch a C call of many rounds) equal, hit times, hits and both
   tapes, to the loop of `lattice_round_plain` and `pattern_scan_plain`
   at the same draws; K13 equal to its plain version on the tapes of :75
   and of ex2_master_oracle; (g) K11's resident rounds at B=16384,
   L=4096, E=256 (8 rounds in one launch, shared and per-member shifts)
   and the fused first passage there (ex2, 30 rounds in calls of 10)
   against the plain versions, then at a row too long to keep resident
   (B=8, L=131,072: one launch a round), both ways; K10's resident
   rounds at the full width (6 rounds in one launch, ex5's and ex4's
   tables, shared and per-member shifts) against the plain rounds, then
   at a row too long to keep (B=8, L=32,768: one launch a round);
   (f) K10 (a resident call of a chunk's 32 rounds on fresh draws, µs a
   round beside the bound of the call's bytes, and a one-round call),
   K11 (one round a call, shared and per-member shifts; and 200
   rounds a call, beside the bound of the call's bytes), K12 and K13
   each alone at B=16384, L=4096, by CUDA events, beside its bound, its
   plain version and, for K13, `torch.bincount`; K12 (modes 0-2, int8
   and int32) and K13 equal to their plain versions bit for bit, twice;
   path (a)'s round split into the float64 draw alone, K10's resident
   round over fresh shifts and uniforms and the rest;
10. the bit-sliced rounds (K14, K15), each path with every count set to 0
   just before and read just after, no plain version called: (a)
   `run_ensemble` with the default route on phase 3's input and seed
   (ex5, B=16384, L=4096, E=256, the transposed [256, 512] words, 2,000
   rounds), K14 2,000 times, K15 four times (two packs, two unpacks), K1
   never, its tapes equal to phase 3's K1 run bit for bit, cold and warm
   µs a round and transitions/s beside K1's; (b) ex4 with
   `bench.py:393-452`'s tape mix at that geometry (the sampling circuit,
   26 random words a round): K14 equal to `apply_round_bitsliced` over 8
   rounds at the same shifts and random words, then 2,000 rounds of the
   default against 2,000 of `bitslice=False`, window counts at cl_k 2
   within 7 sigma + 3e-3 (n_eff = B*L/E), the round's random words'
   draw timed alone; (c) config5
   (`bench.py:229-263`: ex5 at B=10^7, L=32, E=2, the 3-D [2, S, P] word
   view): K15 both ways equal to its plain version on the [B, L] tape
   and on the FSM planes, 500 rounds of K14 equal to 500 of K1, two
   `keep_planes` calls of 250 rounds equal to one 500-round call over the
   same shifts; (d) `tests/test_master.py:75`'s gate through the default
   route (ex2's sampling circuit) with the port's master equation as
   the oracle (z < 6); K14 alone and K15's pack and unpack at (a), (b)
   and (c), by CUDA events, beside their bounds and plain versions (no
   library call computes either);
11. the BFF interpreter (K16-K18), each path with every count set to 0
   just before and read just after, no plain version called: (a)
   `run_ensemble_bff` on ex6-mini-bff at B=16384, L=4096, E=64
   (`bench.py:454-497`'s geometry) for 200 rounds by the default route
   (K17 200 times, K15 three times; cold and warm µs a round and site
   events/s) and by `engine="scan"` (K16 200 times) at the same seed:
   tapes and the [200, 12] opcode totals equal bit for bit, the totals
   summing to rounds x B x E x fuel; (b) K16 on all of (a)'s 16,384
   members, two-tape, self-modifying, lineage and per-member shifts,
   K16 then K18 at rate 0.01, and K17 on (a)'s full-width words for the
   circuits of ex6-mini-bff, -self and -midi, 2 rounds each equal to
   their plain versions bit for bit; (c) the master-equation gates of
   tests/test_bff.py (the conditioned generator, at the reference's
   program ring, which never writes, and at one that does, the ring
   master and the mutation kernel, z < 6, the port's master.py the
   oracle), each first held bit for bit to the plain versions for 2
   rounds at its own geometry (8,192 members, L=4, E=1, a shift a
   member, the mutation gate's rate, lineage on the self-modifying
   ring) through `run_bff_rounds`, and examples/ex6_bff_ensemble.py's
   run (B 4,096, L 256, E 4, 640 rounds), K17 first held bit for bit to
   its plain version for 2 rounds at that geometry, then the run held
   to the claims of tests/test_oracles.py:538-561 on the port's own
   run; (d) K16, K17 and K18 alone at (a)'s geometry by CUDA events
   beside their bounds and plain versions (no library call computes
   any: an interpreter, a gate DAG, a select), and the faithful K17
   unit's build seconds, registers and spills;
12. the weighted frontier (K19-K22, K11's tempered rounds), each path
   with every count set to 0 just before and read just after, no plain
   version called: (a) `run_weighted_frontier_blocked` at
   `bench_frontier`'s geometry (ex5, K=10^6, L=64, plan (6, 512, 4),
   program tapes over 3 symbols) by the default route (K14 on K15's
   words), with `bitslice=False` (K11) and, on ex2 (ex5 has no choose
   to temper), at tau 0.5 (K11's tempered rounds, resident: a launch a
   call of 67 rounds, the block's chunk of draws): ms a block, the
   merge's share (K19, the sort, K20 and K21 alone on the final state),
   branch-steps/s and the last block's distinct members; K19 (with and
   without a flag), K20 (the w/m mode and the weight-only one) and K21
   on the final state, and tempered rounds on ex4 and ex2 at that
   width in both forms (a resident call of 8 rounds, a call of 2 a
   launch a round), equal to their plain versions bit for bit; K11t
   alone: a resident call of 67 rounds (µs a round) and a one-round
   call, each beside its bound; (b) config 5 (ex2,
   K=10^7, L=64, plan (3, 512, 4): the equal-weight merge, ex2's
   sampling circuit) with its peak memory, and the same checks; (c)
   `bench_frontier_per_step`'s geometry (K=10^6, L=32, 50 steps) on
   ex5's table (M = 1) and ex2's (M = 2), one K22 step each equal to
   its plain version bit for bit from the run's weights, from uniform
   ones and after a weight-only merge, the step's kernels by the
   profiler (no library sort or top-k), its split (rank, select, order,
   write) beside the parent design's and, at M = 2, `torch.sort` and
   `torch.topk` of the K*M children; (d)
   examples/ex2_ensemble_crosscheck.py's frontier
   through the port (K=8192, L=128, E=4, 4 seeds x 40 snapshots of 32
   rounds) against the exact closure by the port's `solve`, the
   example's gate (worst relative deviation of the seed mean < 0.10);
   (e) `weighted_first_passage` at the geometry of the JAX package's
   test (K=2048, L=64, 24 one-round blocks: at tau 0.5 K11t's launch a
   round) against brute force at tau
   1 and 0.5 (the test's budget), and on the L=12 ring the absorbing
   ESS-adaptive harness at tau 0.5 and the hit-flagged and binned ones
   at tau 1 against the port's master equation, checked as each harness
   checks (every round, or at block ends: z < 6 over 16 seeds), the
   tempered test's collapse scenario by its thresholds and the binned
   harness split against unsplit at `test_we_binned_*`'s geometry; each
   kernel alone by CUDA events beside its bound, its plain
   version and, for K21, `torch.index_select` of both tapes' rows, K20
   beside the sort's own time;
13. thermodynamics (K23 `sigma_round`, K24 `ledger_round`, in each
   machine's unit built in phase 2, ex4var2's among them) and the host
   instruments, each path with both counts set to 0 just before and read
   just after, no plain version called: (a) `run_ensemble_sigma` on ex2
   and `run_ensemble_ledger` on ex4var2 (examples/ex4var2_ledger.py's G,
   beta_eff 2, its tape mix) at B=16384, L=4096, E=256 for 200 rounds,
   K23 and K24 each launched once a C call (resident: their draws
   come in chunks of 64 rounds, so 4 launches); ex2's sigma held to the rings'
   Ising energy drop (J_eff 2, h -0.25) and ex4var2's to Phi(0) - Phi(T)
   within 1e-8, the counts summing to rounds x E; ms a round by CUDA
   events of that first call, traced by `torch.profiler` (device time
   by kernel and the device's busy share, the host's allocator, launch
   and sync calls, the kernel's first and last launches), of the same
   call again (warm: the figure that stands) and of one more after the
   allocator's cache is emptied; each kernel alone beside its bound, its
   plain version and K11's round without the sums (no library call: a
   walk with a table gather), each as a resident call of 64 rounds (µs a
   round) and a one-round call (a launch a round), each beside its
   bound; (b) examples/ex2_entropy_production.py's
   ensemble (B=8192, L=12, E=1, 24 snapshots of 6 rounds, each one
   resident K23 launch, independent
   sites, bridge-sampled rings, the port's generator) held to
   tests/test_thermo.py:432's gates (z < 6 at every snapshot against the
   exact kernel, the IFT within 6 se, mean sig_tot > 0); (c)
   examples/ex4var2_ledger.py's ensemble panel (B=4096, L=128, E=4, 512
   rounds in 16 calls, each one resident K24 launch) and dual panel
   (cl_k 3, the card's dense dual
   RHS) held to tests/test_thermo.py:387's claims (book_err, decomp_err,
   gibbs_res below 1e-8, F monotone onto F_gibbs, the fuel strokes at 12
   and 7 nats) and the trajectory to examples/ex4var2_ledger_dual.npz
   within abs 1e-10; (d) K23 on ex2 and
   ex4-chemical-turing (irreversible: n_irrev > 0, its 531,441-window
   tables built on the host) and K24 on ex4var2 and ex2 against their
   plain versions bit for bit, shared and per-member shifts, each in
   both forms (single rounds, a launch each, then a resident call of 5
   rounds: ex2's tables staged in shared memory, ex4's read through
   L2), at every
   geometry of (a)-(c): B=16384, L=4096 at E 256 and 1, (b)'s B=8192,
   L=12, E=1 and (c)'s B=4096, L=128, E=4 (the `kernels` line's
   max_abs_err is that of (a)'s shape, machine and shared shifts); (e)
   examples/ex2_closure_error.py's rows (cl_k 3 and 4, 41 samples)
   through the port's closure on the card's RHS, within rtol 1e-8, atol
   1e-14 of the same rows on the CPU and within 4e-9 of the
   committed npz (the JAX package's own CPU run stands 1.4e-9 from it);
14. forward-mode derivatives (K25 `dense_jvp`: K5's kernel in
   `csrc/dense_rhs.cu` and rule on (value, tangent) pairs; K26
   `steady_aug` in `csrc/steady_aug.cu`; K6's third table: Kvaerno
   3(2)'s rows 26-30, the Newton and error sums, the residual; all built
   with the library in phase 2), each path with every count set to 0
   just before and read just after, no plain version called: (a) K25
   against `dense_jvp_plain` bit for bit on ex4 at cl_k 5 and 8, ex4var2
   at cl_k 5, ex2 at cl_k 8, ex1 at cl_k 3 and ex3's dual program at
   cl_k 5, each at two positive p (marginally consistent, iid on each
   tape: every guarded ratio's numerator below its denominator; skewed,
   the first symbol's law apart from the others': the numerator above
   the denominator at many ratios) and at a random one with a third of
   its windows zeroed (ties where a context keeps one live
   continuation), its value path's dy equal to K5's bits, one K25
   launch a call and K3 once a tape in the grid form only (none in the
   block and cluster forms, `dense.launch_form`), K25 and K5 the same
   bits in every form each program can take (`dense.forms_for`), each
   program's form and launches a J v printed, a central difference the witness
   at both positive p (1e-6 of max |J v|), each ratio's distance to a
   kink of max checked to exceed the step; `torch.func.jvp` of the
   closure; K25 alone beside K5 at the same p, its bound, its plain
   version; K25 and K5 at every shape of `time_jvp.py` (the phase's own
   programs) in the chosen and the grid form, a J v call, K25 alone, K5
   alone and an RHS call; (b) K26 at (d)'s and (e)'s programs' sizes
   and at n = 100,000 in every launch form each size can take (one
   block where it fits, the split form after K3), both modes, the
   callers' arithmetic fused (f - L + const, the support mask) and not,
   against its plain version bit for bit; in the chosen form
   (`steady.aug_form`) its kernels a call by the profiler (one in the
   block form), µs a call beside its byte bound; K6's
   Kvaerno entries (both swap states) against their plain versions bit
   for bit at ex4var2 cl_k 5's size, their largest errors recorded,
   timed, stage g4 beside `torch.addmv`; (c)
   `solve(method="kvaerno3")` on ex4var2 at cl_k 5
   from `chemical_turing_v2_p0(5)` to t = 10 (5 samples) within
   tests/test_ode.py:326's bounds of the port's DOP853, K25 launched
   once a J v of the solver's count, its steps, Newton iterations and J v
   printed and a step timed; the same solve with the solver's
   forward-AD duals through `dense.RHSFunction` instead of the one-launch
   shortcut, the same bits, ms a step of each; Robertson on the card
   against scipy's Radau
   (tests/test_ode.py:290); (d) tests/test_steady.py's steady states
   through the card's RHS: ex2 at cl_k 3 (Gibbs within 1e-9, residual
   <= 1e-12), ex1's corner, ex4var2 at cl_k 3 in support mode
   (residual < 5e-8, dead windows exactly 0), the relaxation modes at
   ex2 cl_k 3 and ex2 at cl_k 6 (Gibbs within 2e-9), K25 once a J_G v
   and K26 once a J_G v and a G; (e) examples/ex2_correlations.py's
   continuation over 11 betas on the card within 1e-9 of its committed
   npz, its correlator within 1e-6 of the analytic Ising curve to d = 30;
15. the companion simulators (K27 `ssa_round`, K28 `metropolis`, K29
   `dopri5_batch`, built with the library in phase 2), each path with
   every count set to 0 just before and read just after, no plain
   version called: (a) `gillespie.ssa_batch_tm` at `bench_ssa`'s
   geometry (the autocatalysis network, n0 = (0, 0, 2000), B = 65,536,
   E = 1,000, float32), a first and a warm call, trajectories/s and
   events/s (draws included); K27 against `ssa_round_plain` bit for bit
   in float32 and float64 at B = 65,536 over 50 events, and K27's wide
   form (the network in global memory) so at a network past each of its
   shared-memory limits (33 reactions, 9 species, 9 factors); the moment gates
   of the JAX package's tests/test_models.py:189 at full B (float32
   against the float64 core and against 512 float64 `ssa_trajectories`:
   5-sigma means, variance ratio 0.7-1.4, the largest z printed); (b)
   `ferromagnet.mc_island_history` at examples/ex2_ferromagnet_mc.py's
   geometry (100 chains x 50,000 sites, 4,000 steps of 500 trials in 20
   rounds), steps/s; K28 against `metropolis_plain` bit for bit on all
   100 chains over 20 steps (counts and chains), at 40 trials a round on
   4,097 sites (a partial last word), one trial a round, a ring of 50
   sites and a full warp of 32 trials on 64 sites (`MC_SHAPES`), and on
   4 x 300,000 sites at 25 trials a round over 8 steps; the run against the
   committed JAX run examples/ferromagnet_mc_chain_counts.npz (for L =
   1..4, each of ten 400-step blocks' trial mean within 5 combined
   standard errors) and the analytic band of tests/test_models.py:107
   against `analytic_p_history`; (c) `autocatalysis.integrate_sweep` of
   examples/autocatalysis.py's 12 rows at 10,001 samples; K29 against
   `_solve_batch_plain` on the first 1,001 samples (equal steps a
   member, bit for bit); every final state within 1e-6 relative of
   scipy's DOP853 at rtol 1e-12, atol 1e-14; the closed rows' 2A + 2B +
   M to rtol 1e-7; `find_equilibrium` from the last set's first row to a
   residual below 1e-10; each kernel alone at its path's launch (K27 a
   chunk of 512 events, K28 one of 671 steps, K29 the sweep) beside its
   bound and plain version; the phase's time printed and held under 90
   s (examples/autocatalysis.py and the npz must be in the tree).
16. reverse-mode derivatives (K30 `dense_vjp`, `csrc/dense_vjp.cu`, built
   with the library in phase 2; K6's adjoint rows 31-37): (a) K30 against
   `dense_vjp_plain` bit for bit, p_bar and w_bar, in every launch form
   each program can take (`dense.forms_for`) at `VJP_CASES` (ex2 cl_k 5,
   the inverse design's program, in the block form; the -p rules of ex2
   and ex4var2 at cl_k 4 with a run-time w_const; ex4 cl_k 5 in the grid
   form; a dual program), each at a positive p, one with a third of its
   windows 0 (ties) and one with dead contexts; K30 timed at each in its
   own form and at ex4 cl_k 8 (the median of 25 or 20 calls by CUDA
   events, queued behind a sleep) beside its bound (bytes or float64
   operations, the larger), its plan's bytes printed; K6's adjoint rows
   against their plain versions at n = 32 and 10,000, timed at 10,000;
   (b) examples/ex2_inverse_design.py's geometry (ex2 cl_k 5, 61 samples
   on [0, 30], n_sub 8, p_pair from 1/500 to 1/77): the first gradient
   through `odeint_fixed`'s adjoint against a central difference of the
   port's solve (rtol 1e-6), the loss below 1e-20 within 12 Newton steps;
   (c) `rate_sensitivity` at examples/ex4var2_thermo_sensitivity.py's
   geometry (ex4var2-chemical-turing-p cl_k 4, 11 samples on [0, 100],
   n_sub 100, p(IOIO)): each of the eight gradients against a central
   difference (rtol 1e-5); (d) the implicit gradient at
   examples/ex2_equilibrium.py's geometry (ex2-ferromagnetic-chain-p
   cl_k 4, tol 1e-13, m at beta 0.7): against a central difference of
   two solves and the analytic Ising derivative (rtol 1e-5); (b)-(d) are
   the phase's main path, each with the counts of K30, K6's rows and the
   forward's K3, K5, K25 and K26 set to 0 just before and read just
   after (K30 and K5 launched on each, K6's adjoint rows on (b) and (c),
   K25 and K26 on (d)), no plain version of any of them called.

The line before the last is the `kernels` JSON object; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from chemical_kinetics_and_program_execution_torch import cuda, markov_tapes
from chemical_kinetics_and_program_execution_torch import engine as tengine
from chemical_kinetics_and_program_execution_torch.engine import (
    compile as tcompile,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    dense as tdense,
)
from chemical_kinetics_and_program_execution_torch.engine import dsl as tdsl
from chemical_kinetics_and_program_execution_torch.engine import native
from chemical_kinetics_and_program_execution_torch.engine import rhs as trhs
from chemical_kinetics_and_program_execution_torch.engine import (
    bitslice as tbs,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    bitslice_source,
)
from chemical_kinetics_and_program_execution_torch.engine import bff as tbff
from chemical_kinetics_and_program_execution_torch.engine import (
    bff_bitslice as tbb,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    bff_bitslice_source,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    ensemble as ens,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    frontier as tfr,
)
from chemical_kinetics_and_program_execution_torch import markov as tmarkov
from chemical_kinetics_and_program_execution_torch.engine import k1_source
from chemical_kinetics_and_program_execution_torch.engine import (
    master as tmaster,
)
from chemical_kinetics_and_program_execution_torch.models.initial_states import (  # noqa: E501
    chemical_turing_p0,
    chemical_turing_v2_p0,
    copolymerization_p0,
    ferromagnet_p0,
    ferromagnet_p0_traced,
)
from chemical_kinetics_and_program_execution_torch.engine import (
    parametric as tparam,
)
from chemical_kinetics_and_program_execution_torch.models import (
    autocatalysis,
    ferromagnet,
    gillespie,
)
from chemical_kinetics_and_program_execution_torch.ode import dop853, dopri5
from chemical_kinetics_and_program_execution_torch.ode import (
    steady as tsteady,
)
from chemical_kinetics_and_program_execution_torch.ode.fixed import (
    odeint_fixed,
)
from chemical_kinetics_and_program_execution_torch.ode.integrate import solve
from chemical_kinetics_and_program_execution_torch.ode.kvaerno3 import (
    odeint_kvaerno3,
)
from chemical_kinetics_and_program_execution_torch.ops import (
    closure as tclosure,
)
from chemical_kinetics_and_program_execution_torch.ops import thermo as tth
from chemical_kinetics_and_program_execution_torch.ops.observables import (
    seq_prob_projector,
)
import time_beam_aug
import time_jvp
from card_timing import cuda_ms, k2_tapes

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
B, L = 16384, 4096
E = L // 16
STRIDE = L // E
E_TAIL = E - 1  # the byte path: an E that is not a multiple of 4
NUM_STEPS = 2000
CL_K = 3
MAIN_TAG = "ex5-msrtf-machine"
TAGS = ["ex5-msrtf-machine", "ex4-chemical-turing", "ex2-ferromagnetic-chain"]
# Symbols that reach ex4's reverse reaction at a useful rate.
ACTIVE_SYMBOLS = {"ex4-chemical-turing": ((6, 7), (0, 1, 2, 3, 4, 5))}
K1_REPLACES = ("probes/pallas_plane_round.py:41 fsm_kernel; "
               "probes/pallas_packed32.py:126 fsm_kernel_packed; the JAX "
               "package's engine/ensemble.py:1170 "
               "_apply_plane_round_fsm_stacked (XLA)")
K2_REPLACES = ("the JAX package's engine/ensemble.py:2919 window_counts "
               "(XLA)")


def say(*parts):
    print(*parts, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        say(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def active_draws(gen, tag, dm, device, events=E):
    """Full-width planes over each tape's active symbols, and uniforms a
    third each near 0, near 1 and anywhere in [0, 1)."""
    p_sym, d_sym = ACTIVE_SYMBOLS.get(tag, (range(dm.size_a),) * 2)
    planes = []
    for sym in (p_sym, d_sym):
        sym = torch.as_tensor(list(sym), dtype=torch.int8, device=device)
        idx = torch.randint(0, len(sym), (STRIDE, B, events), generator=gen,
                            device=device)
        planes.append(sym[idx].contiguous())
    u = torch.rand((STRIDE, B, events), generator=gen, device=device)
    pick = torch.randint(0, 3, (STRIDE, B, events), generator=gen,
                         device=device)
    u = torch.where(pick == 0, u * 1e-3,
                    torch.where(pick == 1, 0.95 + 0.05 * u, u))
    return planes[0], planes[1], u.contiguous()


def k1_against_plain(gen, tag, dm, dev, events):
    """K1 and its plain version, one round at every phase on the same
    planes; raises unless bit-identical after each. Returns K1's planes,
    the uniforms, the largest difference and the cells changed."""
    kp, kd, u = active_draws(gen, tag, dm, dev, events)
    pp, pd = kp.clone(), kd.clone()
    start_p, start_d = kp.clone(), kd.clone()
    shifts = torch.as_tensor(
        np.random.RandomState(len(tag)).permutation(STRIDE),
        dtype=torch.int32, device=dev)
    for k in range(STRIDE):
        uk = u[k] if dm.has_choose else None
        ens.plane_round(dm, kp, kd, shifts, k, uk)
        ens.plane_round_plain(dm, pp, pd, shifts, k, uk)
        torch.cuda.synchronize()
        if not (torch.equal(kp, pp) and torch.equal(kd, pd)):
            raise AssertionError(
                f"K1 != plain on {tag}, E={events}, at round {k} "
                f"(shift {int(shifts[k])})")
    err = max(int((x.to(torch.int32) - y.to(torch.int32)).abs().max())
              for x, y in ((kp, pp), (kd, pd)))
    changed = int((kd != start_d).sum() + (kp != start_p).sum())
    if changed == 0:
        raise AssertionError(f"K1 changed nothing on {tag}, E={events}")
    return kp, kd, u, err, changed


def k1_bytes(dm, events=E):
    """Least bytes a round moves: a byte a site for each window cell the
    round must read and each it must write (`k1_source.cell_traffic`),
    plus one float32 uniform a site for a machine with chooses."""
    read, written = k1_source.cell_traffic(dm)
    return B * events * (len(read) + len(written)
                         + (4 if dm.has_choose else 0))


def yardstick_bins(tape, size_a, cl_k):
    """The bin of every window that the reference counts, found apart
    from the port's `window_bins` for the `torch.bincount` yardstick
    (`yardstick_ranks`), flat in row-major order."""
    rank, keep = yardstick_ranks(tape, size_a, cl_k)
    return rank[keep]


def yardstick_ranks(tape, size_a, cl_k):
    """[B, L] bins of every window, found apart from the port's: each
    rank as sum_j tape[:, (i+j) mod L] * (size_a**(cl_k-1-j) mod 2**32),
    taken mod 2**32 by `torch.remainder` and read as an int32; a rank in
    [-n, 0) counts in bin rank + n, any other outside [0, n) is dropped
    (the mask, second)."""
    n, L = size_a**cl_k, tape.shape[1]
    cols = torch.arange(L, device=tape.device)
    rank = torch.zeros(tape.shape, dtype=torch.int64, device=tape.device)
    for j in range(cl_k):
        term = tape[:, (cols + j) % L].to(torch.int64) * pow(
            size_a, cl_k - 1 - j, 2**32)
        rank = torch.remainder(rank + torch.remainder(term, 2**32), 2**32)
    rank = torch.where(rank >= 2**31, rank - 2**32, rank)
    rank = torch.where(rank < 0, rank + n, rank)
    return rank, (rank >= 0) & (rank < n)


def k2_bytes(n_bins):
    """Least bytes K2 moves: the [B, L] int32 tape read once and the
    int64 counts written once."""
    return B * L * 4 + n_bins * 8


# --- Phase 6: the exact SPD closure --------------------------------------------

EX4 = "ex4-chemical-turing"
# The cases of the JAX package's tests/test_engine.py:18-32.
EXACT_CASES = [
    ("ex1-radioactive-decay", 3), ("ex1-radioactive-decay", 5),
    ("ex2-ferromagnetic-chain", 3), ("ex2-ferromagnetic-chain", 5),
    ("ex3-copolymerization", 4), ("ex3var1-copolymerization", 4),
    ("ex3var2-copolymerization", 4), ("ex4-chemical-turing", 3),
    ("ex4var1-chemical-turing", 3), ("ex4var2-chemical-turing", 3),
    ("ex5-msrtf-machine", 3), ("ex5var1-msrtf-machine", 3),
    ("ex6-mini-bff-lite", 2),
]
# Kernel path against the plain version on the card: the same
# arithmetic, the plain scatters' atomics in varying order.
RHS_RTOL, RHS_ATOL = 1e-12, 1e-14
# The reference's ex4 observables at t=2000 (its
# examples/ex4_chemical_turing.py:150-170), as the JAX package's
# tests/test_oracles.py:99-133 pins them.
SEQS = {
    "OAOOO": (5, 0, 5, 5, 5), "OIBOO": (5, 4, 1, 5, 5),
    "OIBIO": (5, 4, 1, 4, 5), "OIOCO": (5, 4, 5, 2, 5),
    "OIOCI": (5, 4, 5, 2, 4), "OIOID": (5, 4, 5, 4, 3),
    "P": (6,), "X": (7,),
}
ORACLE_A = {
    "OAOOO": 1.069972289390935e-08, "OIBOO": 6.515573824924313e-07,
    "OIBIO": 6.515311604360241e-07, "OIOCO": 3.968674272397802e-05,
    "OIOCI": 3.968643987041947e-05, "OIOID": 0.00241751541540069,
    "P": 0.02258485544510012, "X": 0.007415144554899872,
}
ORACLE_B = {
    "OAOOO": 0.00012550563638350954, "OIBOO": 0.00031502540335240174,
    "OIBIO": 5.084130198577003e-05, "OIOCO": 0.0005186964734668385,
    "OIOCI": 9.96749791258151e-05, "OIOID": 0.0013280547249873754,
    "P": 0.0019018941966848447, "X": 0.005598105803315155,
}
SCENARIOS = (("a", 0.04, ORACLE_A), ("b", 0.01, ORACLE_B))
T_END, N_SAMPLES, SOLVE_TOL = 2000.0, 2001, 1e-13
ORACLE_REL, CONV_REL, CONV_ABS = 2e-6, 0.05, 1e-9
RHS_CL_K, SOLVE_CL_K = (5, 6, 7, 8), (5, 6)
SRC = "chemical_kinetics_and_program_execution_torch/csrc/"
EXACT_KERNELS = {
    "K3": ("K3 pyramid", SRC + "dense_rhs.cu",
           "the JAX package's engine/dense.py:423 _levels; markov.py:194 "
           "pyramid (XLA)"),
    "K4": ("K4 signature_weights (phase 0 of K5's launch)",
           SRC + "dense_rhs.cu",
           "the JAX package's engine/dense.py:464-468: markov.py:189 "
           "guarded_ratio_prod, then segment_sum (XLA)"),
    "K5": ("K5 sweep", SRC + "dense_rhs.cu",
           "the JAX package's engine/dense.py:310 _apply_group, :432 "
           "_ratio_tables; markov.py:174 guarded_ratio (XLA)"),
    "K6": ("K6 dop853_arith", SRC + "dop853.cu",
           "the JAX package's ode/dop853.py:157 odeint_dop853_dense; "
           "ode/streamed_solve.py:54-135 (XLA)"),
}
# K4 has no launch of its own: K5's phase 0 runs it, once a K5 launch.
EXACT_WRAPPERS = {"K3": [tdense.pyramid], "K5": [tdense.sweep],
                  "K6": list(dop853.KERNELS)}
K6_NAMES = tuple(f.__name__ for f in dop853.KERNELS)
EXACT_PLAIN = [tdense.pyramid_plain, tdense.signature_weights_plain,
               tdense.sweep_plain, *dop853.PLAIN]


def exact_launches():
    return {k: sum(f.launches for f in fs)
            for k, fs in EXACT_WRAPPERS.items()}


def k6_launches():
    return {f.__name__: f.launches for f in dop853.KERNELS}


class K6HostClock:
    """Host seconds spent inside each K6 wrapper while the solver runs:
    for the duration each wrapper of `dop853` is replaced by one that
    times it with the host's clock (a launch does not wait for the card,
    so that is the host's cost to queue it), then restored. A wrapper
    counts its launches on the module's name for it, so the stand-in
    carries the count meanwhile and hands it back."""

    def __enter__(self):
        self.seconds = dict.fromkeys(K6_NAMES, 0.0)
        self.saved = {name: getattr(dop853, name) for name in K6_NAMES}
        for name, fn in self.saved.items():
            def timed(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
            timed.launches = fn.launches
            setattr(dop853, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            fn.launches = getattr(dop853, name).launches
            setattr(dop853, name, fn)
        return False


def zero_exact_counts():
    for fs in EXACT_WRAPPERS.values():
        for f in fs:
            f.launches = 0
    for f in EXACT_PLAIN:
        f.calls = 0


def held_to_plain(got, want, what):
    """Raises unless ``got`` (the kernels) equals ``want`` (the plain
    version) to rounding; returns the largest difference."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=RHS_RTOL, atol=RHS_ATOL):
        raise AssertionError(f"{what}: kernels != plain, max |diff| {err}")
    return err


def device_spd(gen, n, dev, concentrated=False):
    """A Dirichlet(1) SPD drawn on the card (normalised exponentials), or
    a concentrated one (their fifth powers)."""
    e = -torch.log1p(-torch.rand(n, generator=gen, dtype=torch.float64,
                                 device=dev))
    if concentrated:
        e = e**5
    return e / e.sum()


def queued_reps(reps, launches):
    """``reps`` cut so that a timed run queues under 900 launches behind
    `cuda_ms`' sleeping stream: past the card's queue of pending launches
    the host blocks until the sleep ends, and its time a launch says
    nothing."""
    return max(1, min(reps, 900 // launches))


def wall_ms(fn, reps):
    """Host milliseconds a call of ``fn`` as the host paces it, the card's
    queue drained at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def solve_ex4(dev, cl_k, powered):
    """One ex4 scenario through `markov_tapes.ode_integrate_ivp` on the
    card, observables projected there, the counts set to 0 just before
    and read just after, the host's time inside each K6 wrapper on its
    clock (`K6HostClock`); raises unless K5 and K6 each launched (and K3
    twice a K5 launch in the grid form, never in the block and cluster
    forms), no plain version ran, and K6 launched as the step count says: one
    `dense_eval` an accepted step that holds samples, one `norms` a step
    and two for the initial step, 12 stages a step and 3 more a step
    that holds samples, one `dense_coeffs` a step that holds samples.
    Returns (observables at t=2000, info, seconds, launches, K6's
    launches and host µs a launch by function)."""
    p0 = chemical_turing_p0(cl_k, powered_fraction=powered).ravel()
    proj = seq_prob_projector(list(SEQS.values()), 9, cl_k)
    ts = np.linspace(0.0, T_END, N_SAMPLES)
    zero_exact_counts()
    t0 = time.perf_counter()
    with K6HostClock() as clock:
        obs, info = markov_tapes.ode_integrate_ivp(
            tag=EX4, size_a=9, cl_k=cl_k, p0=p0, ts=ts, backend="torch",
            device=dev, ivp_kwargs=dict(rtol=SOLVE_TOL, atol=SOLVE_TOL,
                                        method="DOP853", project=proj,
                                        return_info=True))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, k6 = exact_launches(), k6_launches()
    plain = sum(f.calls for f in EXACT_PLAIN)
    if obs.shape != (N_SAMPLES, len(SEQS)) or not np.isfinite(obs).all():
        raise AssertionError(f"cl_k {cl_k}: observables {obs.shape}")
    k3_per_rhs = (0, tdense.pyramid_launches(9, cl_k))  # fused, or grid
    if (plain or not launches["K5"] or not launches["K6"]
            or launches["K3"] not in [x * launches["K5"]
                                      for x in k3_per_rhs]):
        raise AssertionError(f"cl_k {cl_k}: launches {launches}, plain "
                             f"calls {plain}")
    steps, sampled = info["num_accepted"] + info["num_rejected"], \
        info["num_sampled"]
    want = {"stage": 1 + 12 * steps + 3 * sampled, "norms": 2 + steps,
            "dense_coeffs": sampled, "dense_eval": sampled}
    if k6 != want:
        raise AssertionError(f"cl_k {cl_k}: K6 launches {k6}, the steps "
                             f"say {want}")
    host_us = {name: clock.seconds[name] * 1e6 / k6[name] for name in k6}
    return (dict(zip(SEQS, obs[-1].tolist())), info, seconds, launches,
            k6, host_us)


def k5_reads(dp):
    """Distinct entries of p and of each lower level that K5's ratios
    read at the plan's live windows (r_le[j] at level j and j - 1, r_re
    and r_le[k] at p and lv[k-1])."""
    a, k = dp.prog.size_a, dp.prog.cl_k
    seen = {j: np.zeros(a**j, dtype=bool) for j in range(k + 1)}
    for st in dp.plan.steps:
        if st.kind in (tdense.INTERIOR, tdense.IDENT):
            continue
        j = st.live()
        seen[st.lev][j] = True
        if st.kind in (tdense.RIGHT, tdense.RSHIFT, tdense.RSHIFT_RUN):
            seen[k - 1][j // a] = True
        else:
            seen[st.lev - 1][j % a ** (st.lev - 1)] = True
    return sum(int(m.sum()) for m in seen.values())


def k5_sector_bytes(dp):
    """A model of K5's traffic in whole 32-byte sectors, computed from the
    plan (not read from the card), as its design would move it with
    nothing found in L2: each compute step reads the sectors of p (or of
    its level) and of the level below that its live windows' ratios
    touch, reads its source and writes its vector (compact, so 8 bytes
    an element), and each emission reads and writes the dy sectors of
    its target windows and reads its vector. Steps whose run is the
    trailing digits (lo = 1) touch a sector for few live windows."""
    a, k = dp.prog.size_a, dp.prog.cl_k
    total = 0
    mask = np.zeros(a**k // 4 + 1, dtype=bool)

    def sectors(idx):
        mask[idx >> 2] = True
        count = int(mask.sum())
        mask[:] = False
        return count

    for st in dp.plan.steps:
        if st.kind == tdense.INTERIOR:
            continue
        j = st.live()
        total += 8 * 2 * st.n  # the source read, the vector written
        if st.kind != tdense.IDENT:
            den = (j // a if st.kind in (tdense.RIGHT, tdense.RSHIFT,
                                         tdense.RSHIFT_RUN)
                   else j % a ** (st.lev - 1))
            total += 32 * (sectors(j) + sectors(den))
        if st.pairs:
            total += 32 * 2 * sectors(st.target_windows()) + 8 * st.n
    return total


def exact_bytes(dp):
    """Least bytes each of K3-K5 moves for one RHS (each input read once,
    each output written once), and the RHS's floor (p read once, dy
    written once)."""
    prog, plan = dp.prog, dp.plan
    n = prog.state_size
    k3 = 8 * prog.pyramid_size  # p read, the levels below written
    W, C = prog.w_num.shape
    gathered = len(np.union1d(prog.w_num, prog.w_den))
    k4 = (8 * W * C + 8 * W + 4 * (prog.num_signatures + 1)
          + 4 * len(prog.pair_world) + 8 * gathered
          + 8 * prog.num_signatures)
    k5 = (8 * n + 8 * k5_reads(dp) + 8 * prog.num_signatures
          + plan.items.nbytes + plan.phase_ptr.nbytes + plan.table.nbytes)
    return {"K3": k3, "K4": k4, "K5": k5, "floor": 16 * n}


def phase0_program(dp):
    """``dp`` with a plan of no sweep phases: a K5 launch then runs its
    phase 0 alone (K4's signature weights) on the grid the whole plan
    gets, which times K4 as K5 runs it, with the launch."""
    plan = dataclasses.replace(dp.plan, phase_ptr=dp.plan.phase_ptr[:1])
    return dataclasses.replace(dp, plan=plan, phase_ptr=dp.phase_ptr[:1])


def eval_times(m, t, h, device):
    """``t`` and m sample times spread over the step (t, t + h]: the times
    `dense_eval` reads from index 1."""
    return torch.as_tensor(np.concatenate([[t], t + h * np.arange(1, m + 1)
                                           / m]), device=device)


def eval_call(F, y, m, out, plain=False):
    """`dense_eval` (or its plain version) of m samples of a step from 0
    of size 0.37, into ``out``; its bound's bytes (the stack's 7 rows and
    y read, m rows written) and, for the library's yardstick, the
    coefficients of `torch.addmm(y, C, F)` that give the same rows."""
    h = 0.37
    ts = eval_times(m, 0.0, h, y.device)
    fn = dop853.dense_eval_plain if plain else dop853.dense_eval
    xs = dop853.fractions(ts, 1, m, 0.0, h).tolist()
    coef = torch.as_tensor(np.asarray([np.cumprod(
        [x if r % 2 == 0 else 1 - x for r in range(7)]) for x in xs]),
        device=y.device)
    return (lambda: fn(F, y, ts, 1, m, 0.0, h, out), 8 * (8 + m) * y.numel(),
            coef)


def time_dense_eval(F, y, m, reps, plain_reps):
    """`dense_eval` of m samples on the card held bit for bit to its plain
    version, timed beside its bound, the plain version and
    `torch.addmm`, with the host's µs a launch."""
    n = y.numel()
    got, want = (dop853.rows_tensor(m, n, y.device) for _ in range(2))
    kern, nbytes, coef = eval_call(F, y, m, got)
    plain, _, _ = eval_call(F, y, m, want, plain=True)
    kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K6 dense_eval m={m} n={n}: kernel != plain, "
                             f"max |diff| {float((got - want).abs().max())}")
    lib_out = torch.addmm(y.expand(m, n), coef, F)
    if not torch.allclose(lib_out, want, rtol=RHS_RTOL, atol=RHS_ATOL):
        raise AssertionError("torch.addmm yardstick != dense_eval")
    host = []
    t = {"ms": cuda_ms(kern, reps, warmup=1, host=host),
         "plain_ms": cuda_ms(plain, plain_reps, warmup=0),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "library_ms": cuda_ms(lambda: torch.addmm(y.expand(m, n), coef, F),
                               reps, warmup=1),
         "launches_per_call": 1, "host_us_per_launch": host[0] * 1e3,
         "samples": m}
    del got, want, lib_out
    return t


def time_exact_kernels(dp, p, gen, out):
    """K3-K5 on ``p`` and K6 on random stages of its size: kernel, plain
    and library times, bounds, host cost a launch; each kernel also held
    to its plain version (K4 as K5's phase 0, the weights it leaves
    behind bit for bit). Adds to ``out`` and returns the largest
    differences."""
    a, k, n = dp.prog.size_a, dp.prog.cl_k, dp.prog.state_size
    err = {}
    low = tdense.pyramid(p, a, k)
    err["K3"] = held_to_plain(low, tdense.pyramid_plain(p, a, k),
                              f"K3 cl_k {k}")
    if not torch.equal(low, tdense.pyramid(p, a, k)):
        raise AssertionError(f"K3 cl_k {k}: two runs differ")
    s_plain = tdense.signature_weights_plain(dp, p, low)
    phase0 = phase0_program(dp)
    for prog in (dp, phase0):
        s = torch.full_like(s_plain, float("nan"))
        tdense.sweep(prog, p, low, s=s)
        torch.cuda.synchronize()
        if not torch.equal(s, s_plain):
            raise AssertionError(f"K4 (K5's phase 0) cl_k {k}: != plain")
        err["K4"] = float((s - s_plain).abs().max())
    dy = tdense.sweep(dp, p, low)
    err["K5"] = held_to_plain(dy, tdense.sweep_plain(dp, p, low, s_plain),
                              f"K5 cl_k {k}")
    if not torch.equal(dy, tdense.sweep(dp, p, low)):
        raise AssertionError(f"K5 cl_k {k}: two runs differ")
    big = k >= 7
    reps, plain_reps = (3, 1) if big else (20, 3)
    bound = exact_bytes(dp)
    per_call = {"K3": tdense.pyramid_launches(a, k), "K4": 1,
                "K5": dp.plan.num_launches}
    s = torch.empty_like(s_plain)
    calls = {"K3": (lambda: tdense.pyramid(p, a, k),
                    lambda: tdense.pyramid_plain(p, a, k)),
             "K4": (lambda: tdense.sweep(phase0, p, low, s=s),
                    lambda: tdense.signature_weights_plain(dp, p, low)),
             "K5": (lambda: tdense.sweep(dp, p, low),
                    lambda: tdense.sweep_plain(
                        dp, p, low, tdense.signature_weights_plain(dp, p,
                                                                   low)))}
    for name, (kern, plain) in calls.items():
        host = []
        ms = cuda_ms(kern, queued_reps(reps, per_call[name]), warmup=1,
                     host=host)
        out.setdefault(name, {})[k] = {
            "ms": ms, "paced_ms": wall_ms(kern, reps),
            "plain_ms": cuda_ms(plain, plain_reps, warmup=0),
            "bound_ms": bound[name] / HBM_BYTES_PER_S * 1e3,
            "library_ms": None, "launches_per_call": per_call[name],
            "host_us_per_launch": host[0] * 1e3 / per_call[name]}
    del low, s, dy
    # K6 at this state size, on random stages.
    # The solver's layout: rows on 256-byte boundaries.
    ks = dop853.rows_tensor(16, n, p.device)
    ks.copy_(torch.rand((16, n), generator=gen, dtype=torch.float64,
                        device=p.device) - 0.5)
    y = torch.rand(n, generator=gen, dtype=torch.float64, device=p.device)
    y_new = y + 1e-3 * ks[3]
    rows = list(range(16))
    f_out, p_out = torch.empty_like(y), torch.empty_like(y)
    F, F_plain = (dop853.rows_tensor(7, n, p.device) for _ in range(2))
    scratch = dop853.norm_scratch(p.device)
    h = 0.37
    b_terms = dop853.tableau_terms(dop853._B_ROW)
    err_kw = dict(y_new=y_new, ks=ks)
    plain_err_kw = dict(err_kw,
                        terms5=dop853.tableau_terms(dop853._E5_ROW),
                        terms3=dop853.tableau_terms(dop853._E3_ROW))
    fns = {
        "stage": (lambda: dop853.stage(y, ks, h, dop853._B_ROW, f_out),
                  lambda: dop853.stage_plain(y, ks, h, b_terms, p_out),
                  8 * (len(b_terms) + 2) * n),
        "norms": (lambda: dop853.norms(dop853._ERR, y, 1e-13, 1e-13,
                                       scratch=scratch, **err_kw),
                  lambda: dop853.norms_plain(dop853._ERR, y, 1e-13, 1e-13,
                                             **plain_err_kw),
                  8 * (2 + len({r for r, _ in plain_err_kw["terms5"]
                                + plain_err_kw["terms3"]})) * n),
        "dense_coeffs": (
            lambda: dop853.dense_coeffs(y, y_new, h, ks[0], ks[12], ks,
                                        rows, F),
            lambda: dop853.dense_coeffs_plain(y, y_new, h, ks[0], ks[12], ks,
                                              rows, F_plain),
            # y, y_new and the stage rows read (f_old and f_new are rows
            # 0 and 12), each once; 7 rows written.
            8 * (2 + len({rows[0], rows[12]}
                         | {r for t in dop853._dense_terms(rows)
                            for r, _ in t}) + 7) * n),
    }
    k6, err["K6"] = {}, 0.0
    for name, (kern, plain, nbytes) in fns.items():
        got, want = kern().clone(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K6 {name} n={n}: kernel != plain, max "
                                 f"|diff| {float((got - want).abs().max())}")
        if not torch.equal(got, kern()):
            raise AssertionError(f"K6 {name} n={n}: two runs differ")
        host = []
        k6[name] = {"ms": cuda_ms(kern, 3 * reps, warmup=1, host=host),
                    "plain_ms": cuda_ms(plain, plain_reps, warmup=0),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "library_ms": None, "launches_per_call": 1,
                    "host_us_per_launch": host[0] * 1e3}
    coef = torch.as_tensor(h * dop853._B, device=p.device)
    k6["stage"]["library_ms"] = cuda_ms(
        lambda: torch.addmv(y, ks[:12].T, coef), 3 * reps, warmup=1)
    # dense_eval: one sample, and at cl_k 7-8 eight (a step's 60-120 rows
    # of 43 M doubles would not fit beside the stages); the solve's mean
    # samples a step at cl_k 5 after the solves (`exact_closure`).
    for m in ((1, 8) if big else (1,)):
        k6[f"dense_eval m={m}"] = time_dense_eval(F, y, m, 3 * reps,
                                                  plain_reps)
    out.setdefault("K6", {})[k] = k6
    del ks, y, y_new, F, F_plain
    return err


def exact_closure(dev, kernels):
    """Phase 6; adds K3-K6 to ``kernels``."""
    gen = torch.Generator(device=dev).manual_seed(7)
    max_err = {"K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0, "RHS": 0.0}
    lib = cuda.load()
    say("K3-K6 entry points in the library built in phase 2: "
        + ", ".join(n for n in ("ckpe_pyramid", "ckpe_dense_sweep",
                                "ckpe_dense_rhs", "ckpe_k6_tableau",
                                "ckpe_k6_stage", "ckpe_k6_norms",
                                "ckpe_k6_dense_coeffs", "ckpe_k6_dense_eval")
                    if hasattr(lib, n)))
    got = markov_tapes._run_validation(device=dev)
    say(f"canary: {got} (exactly the golden list)")

    # dp/dt through the kernels against the plain version on the card.
    rng = np.random.RandomState(7)
    for tag, cl_k in EXACT_CASES:
        prog = tdense.compile_dense(tag, cl_k)
        fn = tdense.make_dense_dy_dt(prog, device=dev)
        for concentrated in (False, True):
            p = torch.as_tensor(rng.dirichlet(
                np.ones(prog.state_size) * (0.2 if concentrated else 1.0)),
                device=dev)
            dy = fn(p)
            if dy.dtype != torch.float64 or abs(float(dy.sum())) >= 1e-13:
                raise AssertionError(f"{tag}: dtype or conservation")
            max_err["RHS"] = max(max_err["RHS"], held_to_plain(
                dy, tdense.dy_dt_dense(fn.device_program, p), tag))
            dp = fn.device_program
            low = tdense.pyramid_plain(p, prog.size_a, cl_k)
            s = torch.full((prog.num_signatures,), float("nan"),
                           dtype=torch.float64, device=dev)
            tdense.sweep(dp, p, low, s=s)
            if not torch.equal(s, tdense.signature_weights_plain(dp, p,
                                                                 low)):
                raise AssertionError(f"{tag}: K5's phase 0 != K4's plain")
    say(f"dp/dt, kernels == plain on the {len(EXACT_CASES)} cases of "
        "tests/test_engine.py:18-32 (random and concentrated SPDs); K5's "
        "signature weights (phase 0) == K4's plain version, bit for bit")

    times, rhs = {}, {}
    for cl_k in RHS_CL_K:
        prog = tdense.compile_dense(EX4, cl_k)
        fn = tdense.make_dense_dy_dt(prog, device=dev)
        dp = fn.device_program
        t0 = time.perf_counter()
        p0 = torch.as_tensor(chemical_turing_p0(
            cl_k, powered_fraction=0.04).ravel(), device=dev)
        p0_s = time.perf_counter() - t0
        for name, p in (("chemical_turing_p0", p0),
                        ("random", device_spd(gen, prog.state_size, dev))):
            max_err["RHS"] = max(max_err["RHS"], held_to_plain(
                fn(p), tdense.dy_dt_dense(dp, p), f"ex4 cl_k {cl_k} {name}"))
        reps = 3 if cl_k >= 7 else 20
        launches = tdense.rhs_pyramid_launches(dp) + dp.plan.num_launches
        zero_exact_counts()
        fn(p0)
        counted = sum(exact_launches().values())
        if counted != launches or counted != (1 if dp.form.kind else 3):
            raise AssertionError(f"cl_k {cl_k}: {counted} launches an RHS, "
                                 f"planned {launches} in the "
                                 f"{tdense.form_name(dp.form)} form")
        host = []
        # Plan arithmetic, printed below and kept out of the kernels line:
        # element-steps, bytes, and K5's traffic as modelled in sectors.
        live, dense = dp.plan.element_steps
        nbytes = exact_bytes(dp)
        floor = nbytes.pop("floor")
        sector_mb = k5_sector_bytes(dp) / 1e6
        rhs[cl_k] = {"device_ms": cuda_ms(lambda: fn(p0),
                                          queued_reps(reps, launches),
                                          warmup=1, host=host),
                     "host_ms": host[0], "wall_ms": wall_ms(lambda: fn(p0),
                                                            reps),
                     "launches": counted,
                     "bound_ms": sum(nbytes.values()) / HBM_BYTES_PER_S * 1e3,
                     "floor_bound_ms": floor / HBM_BYTES_PER_S * 1e3}
        r = rhs[cl_k]
        # Where the RHS lands in the solver: K5 into a padded stage row
        # (`dop853.rows_tensor`, what the solver does), K5 into a row at a
        # stride of n, and a new dy copied into a row at a stride of n;
        # alternated twice, as paced and on the card.
        aligned = dop853.rows_tensor(2, prog.state_size, dev)[1]
        strided = torch.empty((2, prog.state_size), dtype=torch.float64,
                              device=dev)[1]
        forms = {"stage_row": lambda: fn(p0, aligned),
                 "row_at_stride_n": lambda: fn(p0, strided),
                 "copy_at_stride_n": lambda: strided.copy_(fn(p0))}
        paced_reps = 3 if cl_k >= 7 else 200
        for _ in range(2):
            for form, call in forms.items():
                r.setdefault(f"{form}_wall_ms", []).append(
                    wall_ms(call, paced_reps))
        for form, call in forms.items():
            r[f"{form}_device_ms"] = cuda_ms(
                call, queued_reps(reps, launches + 1), warmup=1)
            say(f"ex4 cl_k {cl_k}: RHS {form.replace('_', ' ')} "
                f"{[round(v * 1e3, 1) for v in r[f'{form}_wall_ms']]} us "
                f"as paced, {r[f'{form}_device_ms'] * 1e3:.1f} on the card")
        say(f"ex4 cl_k {cl_k} ({prog.state_size} states, "
            f"{dp.plan.num_groups} groups, {r['launches']} launches an RHS "
            f"(counted); p0 built in {p0_s:.2f} s): kernels == plain on p0 "
            f"and a random SPD; RHS {r['device_ms'] * 1e3:.1f} us device, "
            f"{r['wall_ms'] * 1e3:.1f} us as the host paces it (host "
            f"{r['host_ms'] * 1e3:.1f} us to queue)")
        say(f"ex4 cl_k {cl_k}, from the plan (not measured): K5 in "
            f"{dp.plan.num_phases} phases; live element-steps {live} "
            f"({live / prog.state_size:.3f} A^k) against {dense} dense "
            f"({dense / prog.state_size:.3f} A^k); K3-K5 bytes "
            f"{sum(nbytes.values()) / 1e6:.1f} MB, their bound "
            f"{r['bound_ms'] * 1e3:.2f} us; the RHS floor (p read, dy "
            f"written once) {r['floor_bound_ms'] * 1e3:.2f} us; a model of "
            f"K5's traffic in 32-byte sectors with no L2 hits "
            f"(k5_sector_bytes) {sector_mb:.1f} MB, "
            f"{sector_mb * 1e6 / HBM_BYTES_PER_S * 1e6:.2f} us at 3.35 TB/s")
        errs = time_exact_kernels(dp, p0, gen, times)
        for name, e in errs.items():
            max_err[name] = max(max_err[name], e)
        say(f"cl_k {cl_k}: each of K3-K6 alone == its plain version "
            f"(max |diff| {errs})")
        del fn, dp, p0, p
        torch.cuda.empty_cache()

    # The main path: the paper's ex4 result at cl_k 5, then cl_k 6.
    finals, solves, main_launches = {}, {}, None
    for cl_k in SOLVE_CL_K:
        for label, powered, oracle in SCENARIOS:
            final, info, seconds, launches, k6, host_us = solve_ex4(
                dev, cl_k, powered)
            finals[label, cl_k] = final
            solves[f"{label} cl_k {cl_k}"] = {
                "seconds": seconds, "accepted": info["num_accepted"],
                "rejected": info["num_rejected"], "rhs": info["num_rhs"],
                "sampled_steps": info["num_sampled"], "launches": launches,
                "k6_launches": k6, "k6_host_us_per_launch": host_us}
            if cl_k == SOLVE_CL_K[0]:
                main_launches = ({k: v + launches[k] for k, v in
                                  main_launches.items()}
                                 if main_launches else dict(launches))
            say(f"solve {label}, cl_k {cl_k}: {seconds:.2f} s, "
                f"{info['num_accepted']} accepted, {info['num_rejected']} "
                f"rejected, {info['num_sampled']} holding samples, "
                f"{info['num_rhs']} RHS calls "
                f"({info['num_rhs'] / seconds:.0f} a second); launches "
                f"{launches} (K4: K5's phase 0); plain calls 0")
            say(f"  K6 launches {k6} ({sum(k6.values())}; dense_eval once "
                f"a step that holds samples); host us a launch inside each "
                f"wrapper {({k: round(v, 2) for k, v in host_us.items()})}")
            for name, want in oracle.items():
                got = final[name]
                if (cl_k == SOLVE_CL_K[0]
                        and not abs(got - want) <= ORACLE_REL * abs(want)):
                    raise AssertionError(
                        f"scenario {label} p({name}) = {got!r}, oracle "
                        f"{want!r}")
                if cl_k != SOLVE_CL_K[0]:
                    ref = finals[label, SOLVE_CL_K[0]][name]
                    if not abs(got - ref) <= max(CONV_REL * abs(ref),
                                                 CONV_ABS):
                        raise AssertionError(
                            f"scenario {label} p({name}): cl_k 6 {got!r} "
                            f"vs cl_k 5 {ref!r}")
            rel = max(abs(final[m] / oracle[m] - 1) for m in oracle)
            say(f"  observables at t={T_END:g}: {final}; largest rel. "
                f"distance from the oracle {rel:.3e}"
                + (" (within 2e-6)" if cl_k == SOLVE_CL_K[0] else
                   " (cl_k 6 within rel 0.05, abs 1e-9 of cl_k 5)"))

    # dense_eval at each cl_k 5 solve's mean samples a step.
    small = RHS_CL_K[0]
    n = 9**small
    F = dop853.rows_tensor(7, n, dev)
    F.copy_(torch.rand((7, n), generator=gen, dtype=torch.float64,
                       device=dev) - 0.5)
    y = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    for label, _, _ in SCENARIOS:
        sampled = solves[f"{label} cl_k {small}"]["sampled_steps"]
        m = round((N_SAMPLES - 1) / sampled)
        times["K6"][small][f"dense_eval m={m} (solve {label}'s mean)"] = \
            time_dense_eval(F, y, m, 60, 3)
    del F, y

    for name in ("K3", "K4", "K5"):
        for cl_k, t in times[name].items():
            say(f"{name} cl_k {cl_k}: {t['ms'] * 1e3:.2f} us a call on the "
                f"card, {t['paced_ms'] * 1e3:.2f} as paced "
                f"({t['launches_per_call']} launches, "
                f"{t['ms'] * 1e3 / t['launches_per_call']:.2f} us each) "
                f"against a bound of {t['bound_ms'] * 1e3:.3f} us; plain "
                f"{t['plain_ms'] * 1e3:.1f} us; host "
                f"{t['host_us_per_launch']:.2f} us a launch"
                + (" (K4: a K5 launch over a plan of no sweep phases: "
                   "its phase 0 alone)" if name == "K4" else ""))
    for cl_k, fns in times["K6"].items():
        for fname, t in fns.items():
            lib_name = ("torch.addmm" if fname.startswith("dense_eval")
                        else "torch.addmv")
            say(f"K6 {fname} cl_k {cl_k}: {t['ms'] * 1e3:.2f} us against a "
                f"bound of {t['bound_ms'] * 1e3:.2f} us; plain "
                f"{t['plain_ms'] * 1e3:.1f} us; library "
                + (f"{t['library_ms'] * 1e3:.2f} us ({lib_name})"
                   if t["library_ms"] is not None else "none")
                + f"; host {t['host_us_per_launch']:.2f} us a launch")
    say("at cl_k 5 and 6 the working set (under 50 MB) sits in the 50 MB "
        "L2: those times are launches and host pacing, not bytes")

    full = RHS_CL_K[-1]
    for key, (name, source, replaces) in EXACT_KERNELS.items():
        t5 = times[key][small]
        if key == "K6":
            t5, extra = t5["stage"], {"functions": times["K6"]}
        else:
            extra = {"cl_k8": times[key][full],
                     "launches_per_rhs": t5["launches_per_call"]}
        kernels[key] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # K4 runs as phase 0 of every K5 launch.
            "launches": main_launches["K5" if key == "K4" else key],
            "max_abs_err": max_err[key], "ms": t5["ms"],
            "plain_ms": t5["plain_ms"], "bound_ms": t5["bound_ms"],
            "bound_by": "bytes", "library_ms": t5["library_ms"],
            "shape": "ex4 cl_k 5 (59,049 states)", **extra}
    kernels["K4"]["phase_of"] = "K5"
    kernels["K4"]["launches_per_rhs"] = 0
    kernels["K5"]["rule"] = SRC + "sweep_rule.cuh"
    kernels["K5"]["rhs_ms"] = rhs
    kernels["K5"]["solves"] = solves
    kernels["K5"]["rhs_max_abs_err"] = max_err["RHS"]
    return finals


# --- Phase 7: the gather engine, dual SPDs, chunked solves ------------------

GATHER_CL_K = 5
GATHER_KERNELS = {
    "K7": ("K7 tree_rhs", SRC + "gather_rhs.cu",
           "the JAX package's engine/rhs.py:135 dy_dt_from_tables, :235 "
           "make_dual_dy_dt (XLA)"),
    "K8": ("K8 chain_rhs", SRC + "gather_rhs.cu",
           "the JAX package's engine/rhs.py:216 dy_dt_from_chain_tables "
           "(XLA)"),
}
GATHER_WRAPPERS = {"K7": trhs.tree_rhs, "K8": trhs.chain_rhs}
GATHER_KEY = {"tree": "K7", "chains": "K8"}
GATHER_PLAIN = [trhs.tree_values_plain, trhs.chain_values_plain,
                trhs.scatter_plain]
EXAMPLES = Path(__file__).resolve().parent / "examples"
# The dual examples' committed trajectories (examples/ex3_dual_tape.py,
# examples/ex4_dual_fuel.py), read and never written.
DUAL_ABS = 1e-10


def ex3_dual_y0(p_a_soup):
    return np.concatenate([copolymerization_p0(5, p_a=p_a_soup).ravel(),
                           copolymerization_p0(5, p_a=0.02).ravel()])


def ex4_dual_y0():
    p_fuel = chemical_turing_p0(4, tape_fraction=0.0, powered_fraction=0.04)
    p_tape = chemical_turing_p0(4, tape_fraction=1.0, cursor_fraction=0.001,
                                random01=True)
    return np.concatenate([p_fuel.ravel(), p_tape.ravel()])


# (label, rule, cl_k, y0, atol, artifact): the settings of
# examples/ex3_dual_tape.py:33-59 (both soups) and
# examples/ex4_dual_fuel.py:30-53 at pf 0.04 (rtol 1e-9, DOP853).
DUAL_RUNS = [
    ("ex3 dual (rich)", "ex3-copolymerization", 5,
     lambda: ex3_dual_y0(0.06), 1e-11, "ex3_dual_tape_rich.npz"),
    ("ex3 dual (same)", "ex3-copolymerization", 5,
     lambda: ex3_dual_y0(0.02), 1e-11, "ex3_dual_tape_same.npz"),
    ("ex4 dual fuel (pf 0.04)", EX4, 4, ex4_dual_y0, 1e-12,
     "ex4_dual_fuel_pf0.04.npz"),
]
CHUNK, CHUNK_RTOL, CHUNK_ATOL = 200, 1e-9, 1e-11


def zero_gather_counts():
    zero_exact_counts()
    for f in (*GATHER_WRAPPERS.values(), trhs.scatter, *GATHER_PLAIN):
        if hasattr(f, "launches"):
            f.launches = 0
        else:
            f.calls = 0


def gather_counts():
    """The launches of K3, K5, K6, K7 and K8 since `zero_gather_counts`,
    and the plain versions' calls."""
    counts = exact_launches()
    counts.update({k: f.launches for k, f in GATHER_WRAPPERS.items()})
    plain = sum(f.calls for f in EXACT_PLAIN + GATHER_PLAIN)
    return counts, plain


def nbytes(*tensors):
    return sum(x.element_size() * x.numel() for x in tensors
               if x is not None)


def table_bytes(t):
    """Bytes of K7's or K8's own tables: the dictionaries' pyramid
    indices, every level's (column's) ids, parent offsets and bases and
    signatures, the entries and the targets' CSR."""
    slabs = [sl for lv in t.levels for sl in (lv.node, lv.leaf) if sl]
    return nbytes(t.dict_num, t.dict_den, t.sig, t.ent, t.tgt_ptr,
                  *(x for sl in slabs for x in (sl.id, sl.off, sl.base,
                                                sl.sig)))


def _io_bytes(t):
    """p and the levels read once, the signature weights and dy written
    once, each signature's pairs read once."""
    n, n_sig = t.state_size, t.compiled.num_signatures
    return (8 * n + 8 * tdense.low_size(t.compiled) + 8 * n_sig + 8 * n
            + nbytes(t.pair_num, t.pair_den, t.pair_const, t.csr_ptr))


def gather_bytes(t):
    """Least bytes of K7 or K8 (``t``'s kind) for one RHS: every table
    read once (`table_bytes`), with `_io_bytes`; and of the scatter stage
    alone (the entries and the targets' CSR, the event values read, dy
    written)."""
    scatter = nbytes(t.ent, t.tgt_ptr) + 8 * t.num_values + 8 * t.state_size
    return _io_bytes(t) + table_bytes(t), scatter


def flat_gather_bytes(t):
    """The same least bytes over the flat tables the kernels read before
    the compact ones: an int32 num, den and parent a tree node (the tree
    as built), or an int32 num and den a chain slot; an int32 value
    index and an int32 signed signature an entry; the targets' CSR."""
    c = t.compiled
    tables = (12 * t.num_nodes if t.kind == "tree"
              else 8 * c.e_num.size)
    entries = 8 * t.ent.numel() + 4 * (t.state_size + 1)
    return _io_bytes(t) + tables + entries


def dict_sizes(t):
    """Each tree level's or chain column's dictionary size."""
    firsts = [lv.first for lv in t.levels] + [t.dict_num.numel()]
    return [b - a for a, b in zip(firsts, firsts[1:])]


def describe_tables(t):
    """A line a tree level (its dictionary, width, nodes and leaves), or
    one for the chain columns."""
    sizes = dict_sizes(t)
    if t.kind == "chains":
        return [f"chain columns: dictionaries {sizes} pairs, ids "
                f"{[32 if lv.wide else 16 for lv in t.levels]} bits, "
                f"signatures {32 if t.sig_wide() else 16} bits"]
    return [f"tree level {i}: dictionary {size} pairs, "
            f"{32 if lv.wide else 16}-bit ids and offsets; "
            f"{lv.node.id.numel() if lv.node else 0} nodes, "
            f"{lv.leaf.id.numel()} leaves (events)"
            for i, (lv, size) in enumerate(zip(t.levels, sizes))]


def random_spd_guarded(gen, n, dev):
    """A Dirichlet(1) SPD with p[0] = -1e-13 (the noise guard's regime,
    `tests/test_engine.py:136`)."""
    p = device_spd(gen, n, dev)
    p[0] = -1e-13
    return p


def solve_obs(fn, p0, dev, **kw):
    """ex4's eight observables solved from ``p0`` by ``fn`` (an RHS taking
    ``out=``) to t=2000 on the card; (observables at t=2000, info,
    seconds)."""
    def rhs(y, t, out=None):
        return fn(y, out)

    rhs.takes_out = True
    proj = seq_prob_projector(list(SEQS.values()), 9, GATHER_CL_K)
    t0 = time.perf_counter()
    obs, info = solve(rhs, p0, np.linspace(0.0, T_END, N_SAMPLES),
                      rtol=SOLVE_TOL, atol=SOLVE_TOL, method="dop853",
                      project=proj, return_info=True, device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if obs.shape != (N_SAMPLES, len(SEQS)) or not np.isfinite(obs).all():
        raise AssertionError(f"observables {obs.shape}")
    return dict(zip(SEQS, obs[-1].tolist())), info, seconds


def gather_rhs_checks(dev, gen, fns, wide, dense_fn, compiled, max_err):
    """K7 and K8 at ex4 cl_k 5 against their plain versions on the card
    (bit for bit; twice, the same bits) and against the dense RHS
    (K3-K5), on p0 and on a random SPD with p[0] = -1e-13, over the
    16-bit tables (``fns``' own) and over ``wide`` (every id 32 bits),
    which must give the same dy; their launches an RHS, counted, with no
    plain call; returns the inputs the timings use."""
    k = GATHER_CL_K
    p0 = torch.as_tensor(chemical_turing_p0(k, powered_fraction=0.04)
                         .ravel(), device=dev)
    inputs = (("chemical_turing_p0", p0),
              ("random, p[0] = -1e-13",
               random_spd_guarded(gen, compiled.state_size, dev)))
    for name, p in inputs:
        low = tdense.pyramids(compiled, p)
        want_dense = dense_fn(p)
        for key, fn in fns.items():
            kern = GATHER_WRAPPERS[key]
            dys = []
            for label, t in (("16-bit", fn.tables), ("32-bit", wide[key])):
                got = kern(t, p, low)
                again = kern(t, p, low)
                plain = trhs.gather_plain(t, p)
                torch.cuda.synchronize()
                err = float((got - plain).abs().max())
                if not torch.equal(got, plain):
                    raise AssertionError(f"{key} {label} on {name}: != "
                                         f"plain, max |diff| {err}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{key} {label} on {name}: two "
                                         "runs differ")
                dys.append(got)
                max_err[key] = max(max_err[key], err)
            if not torch.equal(dys[0], dys[1]):
                raise AssertionError(f"{key} on {name}: 16-bit != 32-bit")
            diff = float((dys[0] - want_dense).abs().max())
            if not torch.allclose(dys[0], want_dense, rtol=RHS_RTOL,
                                  atol=RHS_ATOL):
                raise AssertionError(f"{key} on {name}: != dense RHS, max "
                                     f"|diff| {diff}")
            max_err[key + " vs dense"] = max(max_err[key + " vs dense"], diff)
    say(f"ex4 cl_k {k}: K7 and K8 == their plain versions on the card, bit "
        f"for bit, twice the same bits, 16-bit ids == 32-bit ids, and "
        f"within rtol {RHS_RTOL}, atol {RHS_ATOL} of the dense "
        f"RHS (K3-K5) on p0 and a random SPD with p[0] = -1e-13 (max |diff| "
        f"from dense: K7 {max_err['K7 vs dense']:.3e}, K8 "
        f"{max_err['K8 vs dense']:.3e})")
    per_rhs = {}
    for key, fn in fns.items():
        zero_gather_counts()
        fn(p0)
        torch.cuda.synchronize()
        counts, plain = gather_counts()
        want = fn.tables.launches
        if (counts[key] != want or plain
                or counts["K3"] != tdense.pyramid_launches(9, k)):
            raise AssertionError(f"{key}: launches an RHS {counts}, plain "
                                 f"calls {plain}; {want} planned")
        per_rhs[key] = {"K3": counts["K3"], key: counts[key]}
    say(f"launches an RHS (counted; plain calls 0): tree {per_rhs['K7']}, "
        f"chains {per_rhs['K8']}")
    return p0, per_rhs


def time_gather(dev, fns, dense_fn, compiled, p):
    """Each of K7 and K8 on ``p``: the kernel, its plain version, its
    byte bounds (the compact tables and the flat ones), the scatter
    stage alone against `index_add_` of the same signed terms (checked
    against it), and the RHS (K3 and the kernel) against the dense RHS,
    on the card and as the host paces it."""
    low = tdense.pyramids(compiled, p)
    out = {}
    for key, fn in fns.items():
        t = fn.tables
        kern = GATHER_WRAPPERS[key]
        values = (trhs.tree_values_plain if t.kind == "tree"
                  else trhs.chain_values_plain)
        s = tdense.signature_weights_plain(t, p, low)
        ev = values(t, p, low, s)
        tgt = trhs.entry_targets(t)
        terms = trhs.entry_terms(t, ev)
        n = t.state_size

        def library():
            return torch.zeros(n, dtype=torch.float64,
                               device=dev).index_add_(0, tgt, terms)

        lib_dy = library()
        sc_dy = trhs.scatter(t, ev)
        torch.cuda.synchronize()
        if not torch.allclose(lib_dy, sc_dy, rtol=RHS_RTOL, atol=RHS_ATOL):
            raise AssertionError(f"{key}: index_add_ yardstick != scatter")
        full_b, scatter_b = gather_bytes(t)
        host = []
        out[key] = {
            "ms": cuda_ms(lambda: kern(t, p, low), 20, warmup=2, host=host),
            "plain_ms": cuda_ms(lambda: trhs.scatter_plain(t, values(
                t, p, low, tdense.signature_weights_plain(t, p, low))), 2,
                warmup=0),
            "bound_ms": full_b / HBM_BYTES_PER_S * 1e3,
            "bound_flat_tables_ms": flat_gather_bytes(t) / HBM_BYTES_PER_S
            * 1e3,
            "library_ms": cuda_ms(library, 20, warmup=2),
            "scatter_ms": cuda_ms(lambda: trhs.scatter(t, ev), 20, warmup=2),
            "scatter_bound_ms": scatter_b / HBM_BYTES_PER_S * 1e3,
            "launches_per_call": t.launches,
            "host_us_per_launch": host[0] * 1e3 / t.launches,
            "rhs_ms": cuda_ms(lambda: fn(p), 20, warmup=2),
            "rhs_paced_ms": wall_ms(lambda: fn(p), 20),
            "bytes": full_b, "flat_bytes": flat_gather_bytes(t),
            "values": t.num_values, "entries": t.ent.numel()}
        del ev, tgt, terms, lib_dy, sc_dy
    out["dense_rhs_ms"] = cuda_ms(lambda: dense_fn(p), 20, warmup=2)
    out["dense_rhs_paced_ms"] = wall_ms(lambda: dense_fn(p), 20)
    return out


def dual_checks(dev, gen, dense_fn):
    """The dual SPD programs: the examples' dense dual solves against
    their committed trajectories (each solve's counts zeroed before and
    read after: K3 twice an RHS, K5, K6 launched, no plain call), and at
    ex4 cl_k 5 the dense dual RHS against the tree dual RHS and, at
    p_prog = p_data, the halves' sum against the shared RHS."""
    out, progs = {}, {}
    for label, tag, k, make_y0, atol, artifact in DUAL_RUNS:
        y0 = make_y0()
        with np.load(EXAMPLES / artifact) as f:
            want, ts = f["ode_ys"], f["ts"]
        if (tag, k) not in progs:
            progs[tag, k] = tdense.make_dense_dy_dt(
                tdense.compile_dense_dual(tag, k), device=dev)
        fn = progs[tag, k]

        def rhs(y, t, out=None, fn=fn):
            return fn(y, out)

        rhs.takes_out = True
        zero_gather_counts()
        t0 = time.perf_counter()
        got, info = solve(rhs, y0, ts, rtol=1e-9, atol=atol,
                          method="dop853", return_info=True, device=dev)
        seconds = time.perf_counter() - t0
        counts, plain = gather_counts()
        err = float(np.abs(got - want).max())
        if got.shape != want.shape or not err <= DUAL_ABS:
            raise AssertionError(f"{label}: {got.shape} against "
                                 f"{want.shape}, max |diff| {err}")
        if (plain or counts["K5"] != info["num_rhs"]
                or counts["K3"] != info["num_rhs"] * tdense.
                rhs_pyramid_launches(fn.device_program)):
            raise AssertionError(f"{label}: launches {counts}, RHS calls "
                                 f"{info['num_rhs']}, plain calls {plain}")
        out[label] = {"seconds": seconds, "max_abs_err": err,
                      "accepted": info["num_accepted"],
                      "rejected": info["num_rejected"],
                      "rhs": info["num_rhs"], "launches": counts}
        say(f"{label}, cl_k {k} ({2 * fn.device_program.prog.size_a**k} "
            f"states): {seconds:.2f} s, {info['num_accepted']} accepted, "
            f"{info['num_rejected']} rejected, {info['num_rhs']} RHS; max "
            f"|diff| from examples/{artifact} {err:.3e} (bound {DUAL_ABS}); "
            f"launches {counts}, plain calls 0")

    # ex4 at cl_k 5: the dense dual RHS against the tree dual RHS.
    k = GATHER_CL_K
    t0 = time.perf_counter()
    dual_c = tcompile.compile_problem_dual(EX4, k)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_dual = trhs.make_dual_dy_dt(dual_c, device=dev)
    tables_s = time.perf_counter() - t0
    dense_dual = tdense.make_dense_dy_dt(tdense.compile_dense_dual(EX4, k),
                                         device=dev)
    n = 9**k
    pp = random_spd_guarded(gen, n, dev)
    pd = device_spd(gen, n, dev, concentrated=True)
    dense_dy = dense_dual(torch.cat([pp, pd]))
    tree_dy = torch.cat(tree_dual(pp, pd))
    diff = float((dense_dy - tree_dy).abs().max())
    if not torch.allclose(dense_dy, tree_dy, rtol=RHS_RTOL, atol=RHS_ATOL):
        raise AssertionError(f"dual ex4 cl_k {k}: dense != tree, {diff}")
    eq = dense_dual(torch.cat([pp, pp]))
    shared = dense_fn(pp)
    sum_diff = float((eq[:n] + eq[n:] - shared).abs().max())
    if not torch.allclose(eq[:n] + eq[n:], shared, rtol=RHS_RTOL,
                          atol=RHS_ATOL):
        raise AssertionError(f"dual ex4 cl_k {k}: halves != shared, "
                             f"{sum_diff}")
    zero_gather_counts()
    dense_dual(torch.cat([pp, pd]))
    tree_dual(pp, pd)
    torch.cuda.synchronize()
    counts, plain = gather_counts()
    say(f"dual ex4 cl_k {k} (2 x {n} states): compile_problem_dual "
        f"{compile_s:.2f} s ({dual_c.num_events} events), tree tables "
        f"{tables_s:.2f} s ({tree_dual.state_fn.tables.num_nodes} nodes); "
        f"dense dual == tree dual (max |diff| {diff:.3e}); at p_prog = "
        f"p_data the halves sum to the shared RHS (max |diff| "
        f"{sum_diff:.3e}); one RHS each: launches {counts} (K3 once a tape "
        "an RHS), plain calls 0")
    out["ex4 cl_k 5 dense vs tree"] = {"max_abs_diff": diff,
                                       "halves_vs_shared": sum_diff,
                                       "launches": counts,
                                       "compile_s": compile_s,
                                       "tables_s": tables_s}
    if plain:
        raise AssertionError("a plain version ran on the dual path")
    return out


def chunk_checks(dev):
    """ex4 scenario b at cl_k 5 through `markov_tapes.ode_integrate_ivp`
    in chunks of 200 samples with a checkpoint under chiprun_out/,
    against the same solve in one call; the checkpoint's files gone
    after."""
    k = GATHER_CL_K
    p0 = chemical_turing_p0(k, powered_fraction=0.01).ravel()
    ts = np.linspace(0.0, T_END, N_SAMPLES)
    ckpt_dir = Path("chiprun_out") / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpt = str(ckpt_dir / "ex4_b_k5.npy")
    kw = dict(rtol=SOLVE_TOL, atol=SOLVE_TOL, method="DOP853",
              return_info=True)
    args = dict(tag=EX4, size_a=9, cl_k=k, p0=p0, ts=ts, backend="torch",
                device=dev)
    t0 = time.perf_counter()
    full, info_full = markov_tapes.ode_integrate_ivp(**args, ivp_kwargs=kw)
    full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, info = markov_tapes.ode_integrate_ivp(
        **args, ivp_kwargs=dict(kw, chunk_size=CHUNK, checkpoint_path=ckpt))
    chunk_s = time.perf_counter() - t0
    left = sorted(os.listdir(ckpt_dir))
    err = float(np.abs(got - full).max())
    if got.shape != full.shape or not np.allclose(got, full,
                                                  rtol=CHUNK_RTOL,
                                                  atol=CHUNK_ATOL):
        raise AssertionError(f"chunked != unchunked: max |diff| {err}")
    if left:
        raise AssertionError(f"checkpoint files left: {left}")
    ckpt_dir.rmdir()
    rel = float(np.max(np.abs(got - full) / np.maximum(np.abs(full),
                                                         1e-300)))
    say(f"ex4 b cl_k {k}, chunks of {CHUNK} samples with a checkpoint: "
        f"{chunk_s:.2f} s, {info['num_accepted']} accepted, "
        f"{info['num_rejected']} rejected; one call {full_s:.2f} s, "
        f"{info_full['num_accepted']} accepted; max |diff| {err:.3e} (within "
        f"rtol {CHUNK_RTOL}, atol {CHUNK_ATOL}; largest rel {rel:.3e}); "
        "checkpoint files removed")
    return {"seconds": chunk_s, "unchunked_seconds": full_s,
            "accepted": info["num_accepted"],
            "unchunked_accepted": info_full["num_accepted"],
            "max_abs_diff": err}


def gather_phase(dev, kernels, dense_finals):
    """Phase 7; adds K7 and K8 to ``kernels``."""
    gen = torch.Generator(device=dev).manual_seed(11)
    k = GATHER_CL_K
    lib = cuda.load()
    say("K7, K8 entry points in the library built in phase 2: "
        + ", ".join(x for x in ("ckpe_tree_rhs", "ckpe_chain_rhs",
                                "ckpe_gather_scatter") if hasattr(lib, x)))
    t0 = time.perf_counter()
    compiled = tcompile.compile_problem(EX4, k)
    compile_s = time.perf_counter() - t0
    host_bytes = sum(getattr(compiled, f).nbytes
                     for f in tcompile._ARRAY_FIELDS)
    t0 = time.perf_counter()
    tree_fn = trhs.make_dy_dt(compiled, device=dev)
    tree_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain_fn = trhs.make_chain_dy_dt(compiled, device=dev)
    chain_s = time.perf_counter() - t0
    tt, ct = tree_fn.tables, chain_fn.tables
    t0 = time.perf_counter()
    wide = {"K7": trhs.device_tables(compiled, dev, wide=True),
            "K8": trhs.chain_tables(compiled, dev, wide=True)}
    wide_s = time.perf_counter() - t0
    say(f"ex4 cl_k {k} through compile_problem (the C++ expander): "
        f"{compile_s:.2f} s, {compiled.num_worlds} worlds, "
        f"{compiled.num_signatures} signatures, {compiled.num_events} events "
        f"(chains up to {compiled.e_num.shape[1]}), {len(compiled.ev_idx)} "
        f"scatter entries, tables {host_bytes / 1e6:.1f} MB; tree tables "
        f"{tree_s:.2f} s: {tt.num_nodes} nodes in {tt.num_levels} levels, "
        f"{tt.num_node_values} above the last; chain tables {chain_s:.2f} "
        f"s; both with 32-bit ids {wide_s:.2f} s")
    for key, t in (("tree", tt), ("chains", ct)):
        say(f"{key} tables on the card: {table_bytes(t) / 1e6:.1f} MB "
            f"(32-bit ids {table_bytes(wide[GATHER_KEY[key]]) / 1e6:.1f}; "
            f"the flat tables {(flat_gather_bytes(t) - _io_bytes(t)) / 1e6:.1f}"
            f"), {t.dict_num.numel()} dictionary entries")
        for line in describe_tables(t):
            say("  " + line)
    dense_fn = tdense.make_dense_dy_dt(tdense.compile_dense(EX4, k),
                                       device=dev)
    fns = {"K7": tree_fn, "K8": chain_fn}
    max_err = {"K7": 0.0, "K8": 0.0, "K7 vs dense": 0.0, "K8 vs dense": 0.0}
    p0, per_rhs = gather_rhs_checks(dev, gen, fns, wide, dense_fn, compiled,
                                    max_err)
    del wide
    times = time_gather(dev, fns, dense_fn, compiled, p0)
    for key in fns:
        t = times[key]
        say(f"{key} cl_k {k}: {t['ms'] * 1e3:.1f} us a call on the card "
            f"({t['launches_per_call']} launches) against a bound of "
            f"{t['bound_ms'] * 1e3:.1f} us ({t['bytes'] / 1e6:.1f} MB; over "
            f"the flat tables {t['bound_flat_tables_ms'] * 1e3:.1f} us, "
            f"{t['flat_bytes'] / 1e6:.1f} MB); plain "
            f"{t['plain_ms'] * 1e3:.1f} us; scatter alone "
            f"{t['scatter_ms'] * 1e3:.1f} us against a bound of "
            f"{t['scatter_bound_ms'] * 1e3:.1f} us and index_add_ of the "
            f"same signed terms {t['library_ms'] * 1e3:.1f} us; the "
            f"RHS (K3 + {key}) {t['rhs_ms'] * 1e3:.1f} us on the card, "
            f"{t['rhs_paced_ms'] * 1e3:.1f} as paced; host "
            f"{t['host_us_per_launch']:.2f} us a launch")
    say(f"dense RHS (K3-K5) on the same p: {times['dense_rhs_ms'] * 1e3:.1f}"
        f" us on the card, {times['dense_rhs_paced_ms'] * 1e3:.1f} as paced")

    # The main paths: ex4 scenario a solved through the tree engine
    # (build_dy_dt(engine="tree")) and through the chain engine.
    solves, main_launches = {}, {}
    p0_host = chemical_turing_p0(k, powered_fraction=0.04).ravel()
    t0 = time.perf_counter()
    fn, prog = tengine.build_dy_dt(EX4, k, engine="tree", device=dev)
    build_s = time.perf_counter() - t0
    for key, label, f in (("K7", "tree", fn), ("K8", "chains", chain_fn)):
        zero_gather_counts()
        final, info, seconds = solve_obs(f, p0_host, dev)
        counts, plain = gather_counts()
        if plain or counts[key] == 0 or counts["K3"] == 0 or \
                counts["K6"] == 0 or counts[key] != info["num_rhs"] * \
                f.tables.launches:
            raise AssertionError(f"{label} solve: launches {counts}, RHS "
                                 f"{info['num_rhs']}, plain calls {plain}")
        main_launches[key] = counts[key]
        rel = max(abs(final[m] / ORACLE_A[m] - 1) for m in ORACLE_A)
        gap = max(abs(final[m] / dense_finals["a", k][m] - 1)
                  for m in ORACLE_A)
        if not rel <= ORACLE_REL:
            raise AssertionError(f"{label} solve: rel {rel} from ORACLE_A")
        solves[label] = {"seconds": seconds, "accepted":
                         info["num_accepted"], "rejected":
                         info["num_rejected"], "rhs": info["num_rhs"],
                         "launches": counts, "oracle_rel": rel,
                         "dense_gap_rel": gap}
        say(f"solve a, cl_k {k}, {label} engine"
            + (f" (build_dy_dt {build_s:.2f} s)" if key == "K7" else "")
            + f": {seconds:.2f} s, {info['num_accepted']} accepted, "
            f"{info['num_rejected']} rejected, {info['num_rhs']} RHS; "
            f"launches {counts}, plain calls 0; observables within "
            f"{rel:.3e} rel of ORACLE_A (bound {ORACLE_REL}), {gap:.3e} rel "
            "of phase 6's dense solve")
    del fn, prog
    dual = dual_checks(dev, gen, dense_fn)
    chunked = chunk_checks(dev)
    for key, (name, source, replaces) in GATHER_KERNELS.items():
        t = times[key]
        kernels[key] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[key],
            "max_abs_err": max_err[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "library": "torch.Tensor.index_add_ of the signed terms (the "
                       "scatter stage; scatter_ms is that stage alone)",
            "bound_flat_tables_ms": t["bound_flat_tables_ms"],
            "scatter_ms": t["scatter_ms"],
            "scatter_bound_ms": t["scatter_bound_ms"],
            "launches_per_rhs": t["launches_per_call"],
            "rhs_ms": t["rhs_ms"], "dense_rhs_ms": times["dense_rhs_ms"],
            "max_abs_diff_from_dense": max_err[key + " vs dense"],
            "shape": f"ex4 cl_k 5: {t['values']} events, "
                     f"{t['entries']} scatter entries",
            "rule": SRC + "gather_rule.cuh", "solve": solves[
                "tree" if key == "K7" else "chains"]}
    kernels["K7"]["dual"] = dual
    kernels["K7"]["chunked_solve"] = chunked
    kernels["K7"]["compile"] = {"seconds": compile_s,
                                "events": compiled.num_events,
                                "nodes": tt.num_nodes,
                                "table_bytes": host_bytes,
                                "tree_tables_s": tree_s,
                                "chain_tables_s": chain_s}


# --- Phase 8: loose-tolerance solves, pruned exact mode --------------------------

LOOSE_TOL = 1e-9  # examples/ex3_copolymerization.py, ex6_mini_bff.py
ARTIFACT_ABS = 1e-10
# (path, rule, cl_k, t_end, samples, artifact): a is
# examples/ex3_copolymerization.py's var2 run at cl_k 8 (65,536 states,
# 101 samples), the repository's largest committed loose-tolerance solve;
# b its ex3 run at cl_k 6. Both through `markov_tapes.ode_integrate` with
# the examples' rtol = atol = 1e-9 and the default routing (dopri5).
LOOSE_RUNS = [
    ("a", "ex3var2-copolymerization", 8, 200.0, 101, "ex3_var2_k8.npz"),
    ("b", "ex3-copolymerization", 6, 1000.0, 1001, "ex3_k6.npz"),
]
# Path c: the exact side of examples/ex6_bff_self_spd.py (its settings,
# RK4 of 8 substeps a snapshot over the artifact's ts), held to the
# artifact's mass and cls_spd.
EX6_SELF, EX6_SELF_EPS, EX6_SELF_THR = "ex6-mini-bff-self", 0.02, 1e-7
EX6_SELF_WORLDS = (4517, 9912)  # live, enumerated (the artifact's n_worlds)
EX6_SELF_ABS = 1e-11
# Path d: examples/ex6_mini_bff.py at its defaults; each segment's kept
# worlds and the final mass from the JAX package's run on the CPU
# (tests/test_torch_pruned.py holds the port to that package on the CPU).
EX6_MINI = "ex6-mini-bff"
EX6_MINI_COUNTS = [20, 20, 14, 12, 10, 10, 8, 8, 6, 6]
EX6_MINI_FINAL_MASS = 0.32837033166511376
EX6_MINI_ABS = 1e-10  # a tenth of the solve's tolerance
DENSE_STEPS_A = 29  # phase 6's dense DOP853, ex4 a at cl_k 5
STEP_CL_K = 5  # path e
LOOSE_WRAPPERS = {"K3": [tdense.pyramid], "K5": [tdense.sweep],
                  "K6": list(dop853.KERNELS), "K9": [tdense.world_mass]}
K6_DP5 = ("K6 dop853_arith: dopri5 rows, error sum; step-clamped DOP853",
          SRC + "dop853.cu",
          "the JAX package's ode/dopri5.py:48 odeint_dopri5, :43 _rms_norm; "
          "ode/dop853.py:45 odeint_dop853 (XLA)")
K9 = ("K9 world_mass", SRC + "world_mass.cu",
      "the JAX package's engine/dense.py:579 (make_dense_dy_dt with_mass: "
      "jnp.sum of m_const * guarded_ratio_prod) (XLA)")


def loose_launches():
    return {k: sum(f.launches for f in fs)
            for k, fs in LOOSE_WRAPPERS.items()}


def zero_loose_counts():
    zero_exact_counts()
    tdense.world_mass.launches = 0
    tdense.world_mass_plain.calls = 0


def plain_calls():
    return (sum(f.calls for f in EXACT_PLAIN)
            + tdense.world_mass_plain.calls)


class SolveInfo:
    """For the duration, `markov_tapes`' `solve` also keeps each call's
    ``info`` (steps, RHS calls) in ``self.infos``; the caller's result is
    unchanged."""

    def __enter__(self):
        self.infos, self.saved = [], markov_tapes.solve

        def solve_kept(*args, **kw):
            want_info = kw.pop("return_info", False)
            ys, info = self.saved(*args, return_info=True, **kw)
            self.infos.append(info)
            return (ys, info) if want_info else ys

        markov_tapes.solve = solve_kept
        return self

    def __exit__(self, *exc):
        markov_tapes.solve = self.saved
        return False


def iid_spd(psym, cl_k):
    """The product SPD of iid symbols (the examples' `_common.iid_spd`)."""
    out = np.array([1.0])
    for _ in range(cl_k):
        out = np.kron(out, np.asarray(psym, dtype=np.float64))
    return out


def mutant_class_masks(size_a, dot, cl_k):
    """examples/ex6_bff_self_spd.py:63-75: [size_a, size_a**cl_k] 0/1
    masks of the windows with exactly one non-dot symbol, equal to s."""
    masks = np.zeros((size_a, size_a**cl_k))
    for w in range(size_a**cl_k):
        digs, r = [], w
        for _ in range(cl_k):
            r, d = divmod(r, size_a)
            digs.append(d)
        non = [d for d in digs if d != dot]
        if len(non) == 1:
            masks[non[0], w] = 1.0
    return masks


def counted_path(label, fn, need):
    """Runs the main path ``fn`` with every count set to 0 just before and
    read just after; raises unless each kernel of ``need`` launched and
    no plain version ran. (K3 runs on these paths only for a program in
    the grid form: the block and cluster forms form the levels inside
    K5's launch, `dense.launch_form`.) Returns (fn's result, seconds,
    launches, K6's launches by function, host µs a K6 launch inside
    each wrapper)."""
    zero_loose_counts()
    t0 = time.perf_counter()
    with K6HostClock() as clock:
        result = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, k6, plain = loose_launches(), k6_launches(), plain_calls()
    if plain or any(launches[k] == 0 for k in need):
        raise AssertionError(f"path {label}: launches {launches}, plain "
                             f"calls {plain}")
    host_us = {name: clock.seconds[name] * 1e6 / k6[name]
               for name in k6 if k6[name]}
    return result, seconds, launches, k6, host_us


def k6_steps_say(label, info, k6, fsal_stages):
    """Raises unless K6 launched as the step count says (``fsal_stages``
    stage launches a step: 7 for dopri5, 12 for dop853-step; one `norms`
    a step and two for the initial step)."""
    steps = info["num_accepted"] + info["num_rejected"]
    want = {"stage": 1 + fsal_stages * steps, "norms": 2 + steps,
            "dense_coeffs": 0, "dense_eval": 0}
    if k6 != want:
        raise AssertionError(f"path {label}: K6 launches {k6}, the steps "
                             f"say {want}")


def dopri5_kernel_checks(dev, gen, n):
    """K6's dopri5 rows at n states: `stage` at every row of the second
    table in both swap states and `norms` in dopri5's mode, each the
    plain version's bits and the same twice; the B5 stage and the error
    sum timed beside their bounds, their plain versions and, for the
    stage, `torch.addmv`."""
    ks = dop853.rows_tensor(7, n, dev)
    ks.copy_(torch.rand((7, n), generator=gen, dtype=torch.float64,
                        device=dev) - 0.5)
    y = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    y_new = y + 1e-3 * ks[3]
    fsal, h = dopri5.FSAL, 0.37
    out, want = torch.empty_like(y), torch.empty_like(y)
    rows = [dop853._EULER, *dop853.DP5_ROWS[1:], dop853.DP5_B5_ROW,
            dop853.DP5_ERR_ROW]
    scratch = dop853.norm_scratch(dev)
    for swap in (0, 1):
        for which in rows:
            got = dop853.stage(y, ks, h, which, out, swap, fsal).clone()
            plain = dop853.stage_plain(y, ks, h, dop853.tableau_terms(
                which, swap, fsal), want)
            torch.cuda.synchronize()
            if not (torch.equal(got, plain) and torch.equal(
                    got, dop853.stage(y, ks, h, which, out, swap, fsal))):
                raise AssertionError(f"K6 dopri5 stage row {which} swap "
                                     f"{swap} n={n}: != plain")
        kw = dict(y_new=y_new, ks=ks, swap=swap, h=h, fsal=fsal,
                  rows=(dop853.DP5_ERR_ROW,))
        got = dop853.norms(dop853._ERR_H, y, LOOSE_TOL, LOOSE_TOL,
                           scratch=scratch, **kw).clone()
        plain = dop853.norms_plain(
            dop853._ERR_H, y, LOOSE_TOL, LOOSE_TOL, y_new=y_new, ks=ks, h=h,
            terms5=dop853.tableau_terms(dop853.DP5_ERR_ROW, swap, fsal))
        if not (torch.equal(got, plain) and torch.equal(
                got, dop853.norms(dop853._ERR_H, y, LOOSE_TOL, LOOSE_TOL,
                                  scratch=scratch, **kw))):
            raise AssertionError(f"K6 dopri5 error sum swap {swap} n={n}: "
                                 "!= plain")
    b5 = dop853.tableau_terms(dop853.DP5_B5_ROW, 0, fsal)
    err = dop853.tableau_terms(dop853.DP5_ERR_ROW, 0, fsal)
    kw = dict(y_new=y_new, ks=ks, h=h, fsal=fsal, rows=(dop853.DP5_ERR_ROW,))
    coef = torch.as_tensor(h * dop853.DP5_B5, device=dev)
    times = {}
    for name, kern, plain, nbytes in (
            ("stage (B5)",
             lambda: dop853.stage(y, ks, h, dop853.DP5_B5_ROW, out, 0, fsal),
             lambda: dop853.stage_plain(y, ks, h, b5, want),
             8 * (len(b5) + 2) * n),
            ("norms (B5 - B4)",
             lambda: dop853.norms(dop853._ERR_H, y, LOOSE_TOL, LOOSE_TOL,
                                  scratch=scratch, **kw),
             lambda: dop853.norms_plain(dop853._ERR_H, y, LOOSE_TOL,
                                        LOOSE_TOL, y_new=y_new, ks=ks, h=h,
                                        terms5=err),
             8 * (2 + len(err)) * n)):
        host = []
        times[name] = {"ms": cuda_ms(kern, 60, warmup=1, host=host),
                       "plain_ms": cuda_ms(plain, 5, warmup=0),
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "library_ms": None, "host_us_per_launch": host[0] * 1e3}
    lib_out = torch.addmv(y, ks.T, coef)
    if not torch.allclose(lib_out, want, rtol=RHS_RTOL, atol=RHS_ATOL):
        raise AssertionError("torch.addmv yardstick != dopri5's B5 stage")
    times["stage (B5)"]["library_ms"] = cuda_ms(
        lambda: torch.addmv(y, ks.T, coef), 60, warmup=1)
    del ks, y, y_new
    return times


def world_mass_bytes(dp):
    """K9's bytes: the chains (two int32 a factor), m_const and each
    pyramid entry the chains name read once, the mass written."""
    idx = torch.unique(torch.cat([dp.m_num.reshape(-1),
                                  dp.m_den.reshape(-1)]))
    return (8 * dp.m_num.numel() + 8 * dp.m_const.numel()
            + 8 * idx.numel() + 8)


def world_mass_checks(dev, gen, dp, p, label, mass_one=False):
    """K9 against its plain version on ``p`` and on a random SPD, bit for
    bit and the same bits twice (mass 1 within 1e-12 where
    ``mass_one``); returns its time on ``p`` beside its bound and its
    plain version."""
    a, k = dp.prog.size_a, dp.prog.cl_k
    scratch = tdense.mass_scratch(dev)
    for q in (p, device_spd(gen, dp.prog.state_size, dev, True)):
        low = tdense.pyramid_plain(q, a, k)
        got = tdense.world_mass(dp, q, low, scratch).clone()
        again = tdense.world_mass(dp, q, low, scratch)
        plain = tdense.world_mass_plain(dp, q, low)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(got, again)):
            raise AssertionError(f"K9 {label}: kernel {got.item()!r} != "
                                 f"plain {plain.item()!r}")
        if mass_one and abs(got.item() - 1.0) >= 1e-12:
            raise AssertionError(f"K9 {label}: mass {got.item()!r}, not 1")
    low = tdense.pyramid_plain(p, a, k)
    host = []
    return {"ms": cuda_ms(lambda: tdense.world_mass(dp, p, low, scratch),
                          100, warmup=1, host=host),
            "plain_ms": cuda_ms(lambda: tdense.world_mass_plain(dp, p, low),
                                5, warmup=0),
            "bound_ms": world_mass_bytes(dp) / HBM_BYTES_PER_S * 1e3,
            "library_ms": None, "host_us_per_launch": host[0] * 1e3,
            "worlds": dp.m_const.numel(), "chain": dp.m_num.shape[1]}


def loose_phase(dev, kernels):
    """Phase 8; adds K6's dopri5 rows and K9 to ``kernels``."""
    gen = torch.Generator(device=dev).manual_seed(13)
    say("K9 entry point in the library built in phase 2: "
        + ("ckpe_world_mass" if hasattr(cuda.load(), "ckpe_world_mass")
           else "missing"))
    paths, totals = {}, {"K3": 0, "K5": 0, "K6": 0, "K9": 0}

    def record(label, launches, **extra):
        for key in totals:
            totals[key] += launches.get(key, 0)
        paths[label] = {"launches": launches, **extra}

    # a, b: ex3var2 at cl_k 8 and ex3 at cl_k 6 by dopri5 (default routing).
    k6_dp5 = {}
    for label, tag, cl_k, t_end, samples, artifact in LOOSE_RUNS:
        p0 = copolymerization_p0(cl_k).ravel()
        ts = np.linspace(0.0, t_end, samples)

        def run():
            with SolveInfo() as kept:
                ys = markov_tapes.ode_integrate(
                    tag=tag, size_a=4, cl_k=cl_k, p0=p0, ts=ts,
                    backend="torch", device=dev,
                    odeint_kwargs=dict(rtol=LOOSE_TOL, atol=LOOSE_TOL))
            return ys, kept.infos[0]

        (ys, info), seconds, launches, k6, host_us = counted_path(
            label, run, ("K5", "K6"))
        k6_steps_say(label, info, k6, 7)
        want = np.load(EXAMPLES / artifact)["ode_ys"]
        if ys.shape != want.shape or not np.isfinite(ys).all():
            raise AssertionError(f"path {label}: {ys.shape} against "
                                 f"{want.shape}")
        err = float(np.abs(ys - want).max())
        if err > ARTIFACT_ABS:
            raise AssertionError(f"path {label}: max |diff| {err} from "
                                 f"examples/{artifact}")
        record(label, launches, seconds=seconds, err=err,
               accepted=info["num_accepted"], rejected=info["num_rejected"],
               rhs=info["num_rhs"], k6_launches=k6,
               k6_host_us_per_launch=host_us)
        say(f"path {label}: {tag} cl_k {cl_k} ({4**cl_k} states, {samples} "
            f"samples to t={t_end:g}) by dopri5 through "
            f"markov_tapes.ode_integrate: {seconds:.2f} s, "
            f"{info['num_accepted']} accepted, {info['num_rejected']} "
            f"rejected, {info['num_rhs']} RHS calls "
            f"({info['num_rhs'] / seconds:.0f} a second); launches "
            f"{launches}, K6 {k6}; host us a K6 launch "
            f"{({k: round(v, 2) for k, v in host_us.items()})}; max |diff| "
            f"from examples/{artifact} {err:.3e} (within {ARTIFACT_ABS:g})")
        if label == "a":
            k6_dp5 = dopri5_kernel_checks(dev, gen, 4**cl_k)
            say(f"K6 dopri5 rows at {4**cl_k} states: every row, both swap "
                "states, and the error sum == plain, bit for bit, twice")
        torch.cuda.empty_cache()

    # c: the exact side of examples/ex6_bff_self_spd.py.
    prob = tdsl.get_problem(EX6_SELF)
    a, dot = prob.size_a, prob.symbols.index("dot")
    p1 = np.full(a, EX6_SELF_EPS / (a - 1))
    p1[dot] = 1.0 - EX6_SELF_EPS
    p0 = iid_spd(p1, 3)
    t0 = time.perf_counter()
    prog = tdense.compile_dense(EX6_SELF, 3, p_ref=p0,
                                prune_threshold=EX6_SELF_THR,
                                max_worlds=20_000_000)
    fn = tdense.make_dense_dy_dt(prog, with_mass=True, device=dev)
    build_s = time.perf_counter() - t0
    dp = fn.device_program
    worlds = (prog.num_worlds, len(prog.m_const))
    if worlds != EX6_SELF_WORLDS:
        raise AssertionError(f"ex6-self: {worlds} worlds, "
                             f"{EX6_SELF_WORLDS} wanted")
    art = np.load(EXAMPLES / "ex6_bff_self_spd.npz")
    if int(art["n_worlds"]) != prog.num_worlds:
        raise AssertionError("ex6-self: the artifact's n_worlds")
    say(f"ex6-self pruned at {EX6_SELF_THR:g}: {worlds[0]} live worlds of "
        f"{worlds[1]} enumerated, {prog.num_signatures} signatures, "
        f"{dp.plan.num_groups} groups, K5 in {dp.plan.num_phases} phases "
        f"(work {dp.plan.work_size} doubles, items "
        f"{dp.plan.items.shape[0]}, table {dp.plan.table.size}); compiled "
        f"and on the card in {build_s:.2f} s")
    p0_dev = torch.as_tensor(p0, device=dev)
    for q in (p0_dev, device_spd(gen, prog.state_size, dev, True)):
        dy, _ = fn(q)
        held_to_plain(dy, tdense.dy_dt_dense(dp, q), "ex6-self dp/dt")
    k9_self = world_mass_checks(dev, gen, dp, p0_dev, "ex6-self")
    rhs_ms = cuda_ms(lambda: fn(p0_dev), 60, warmup=1)
    masks = mutant_class_masks(a, dot, 3)
    ts = art["ts"]

    def rk4():
        """examples/ex6_bff_self_spd.py:126-141 on the card."""
        y = p0_dev.clone()
        ys, mass = [y.clone()], [fn(y)[1]]
        for i in range(len(ts) - 1):
            h = (ts[i + 1] - ts[i]) / 8
            for _ in range(8):
                k1 = fn(y)[0]
                k2 = fn(y + 0.5 * h * k1)[0]
                k3 = fn(y + 0.5 * h * k2)[0]
                k4 = fn(y + h * k3)[0]
                y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            ys.append(y.clone())
            mass.append(fn(y)[1])
        return (torch.stack(ys).cpu().numpy(),
                torch.stack(mass).cpu().numpy())

    (ys, mass), seconds, launches, _, _ = counted_path(
        "c", rk4, ("K5", "K9"))
    cls_spd = ys @ masks.T
    err_mass = float(np.abs(mass - art["mass"]).max())
    err_cls = float(np.abs(cls_spd - art["cls_spd"]).max())
    if max(err_mass, err_cls) > EX6_SELF_ABS:
        raise AssertionError(f"path c: mass {err_mass}, cls_spd {err_cls} "
                             f"from examples/ex6_bff_self_spd.npz")
    record("c", launches, seconds=seconds, mass_err=err_mass,
           cls_spd_err=err_cls, rhs_ms=rhs_ms)
    say(f"path c: ex6-self RK4, {8 * (len(ts) - 1)} substeps, "
        f"{launches['K9']} RHS with mass: {seconds:.2f} s, launches "
        f"{launches} (3 an RHS: K3, K5, K9); mass {mass[0]:.10f} -> "
        f"{mass[-1]:.10f}; max |diff| from the artifact: mass "
        f"{err_mass:.3e}, cls_spd {err_cls:.3e} (within {EX6_SELF_ABS:g}); "
        f"an RHS with mass {rhs_ms * 1e3:.1f} us on the card")
    ex5 = tdense.compile_dense("ex5-msrtf-machine", 3, prune_threshold=1e-30)
    dp5 = tdense.device_program(ex5, dev)
    world_mass_checks(dev, gen, dp5, device_spd(gen, ex5.state_size, dev),
                      "ex5 at threshold 1e-30", mass_one=True)
    say("K9 == plain, bit for bit, twice: ex6-self on p0 and a random SPD, "
        "ex5 at threshold 1e-30 (mass 1 within 1e-12)")

    # d: examples/ex6_mini_bff.py's re-pruned loop at its defaults.
    psym = np.full(12, 0.1 / 11)
    psym[0] = 0.9
    ts = np.linspace(0.0, 50.0, 201)
    seg = (len(ts) - 1) // 10

    def mini_loop():
        y, counts, masses, infos = iid_spd(psym, 3), [], [], []
        for s in range(10):
            prog = tdense.compile_dense(EX6_MINI, 3, p_ref=y,
                                        prune_threshold=1e-4,
                                        max_worlds=1_000_000)
            fn = tdense.make_dense_dy_dt(prog, with_mass=True, device=dev)
            ys, info = solve(lambda y_, t: fn(y_)[0], y,
                             ts[s * seg:(s + 1) * seg + 1], rtol=LOOSE_TOL,
                             atol=LOOSE_TOL, return_info=True, device=dev)
            masses.extend(float(fn(yy)[1]) for yy in ys[1:])
            y = ys[-1]
            counts.append(prog.num_worlds)
            infos.append(info)
        return counts, masses, infos

    (counts, masses, infos), seconds, launches, k6, _ = counted_path(
        "d", mini_loop, ("K5", "K6", "K9"))
    err = abs(masses[-1] - EX6_MINI_FINAL_MASS)
    if counts != EX6_MINI_COUNTS or err > EX6_MINI_ABS:
        raise AssertionError(f"path d: kept worlds {counts}, final mass "
                             f"{masses[-1]!r}; the JAX package's "
                             f"{EX6_MINI_COUNTS}, {EX6_MINI_FINAL_MASS!r}")
    steps = [i["num_accepted"] + i["num_rejected"] for i in infos]
    record("d", launches, seconds=seconds, counts=counts,
           final_mass=masses[-1], steps=steps)
    say(f"path d: ex6_mini_bff's 10 segments in {seconds:.2f} s: kept "
        f"worlds {counts} (the JAX package's), steps {steps}, final mass "
        f"{masses[-1]!r} ({err:.3e} from the JAX package's, within "
        f"{EX6_MINI_ABS:g}), min {min(masses):.6f}; launches {launches}")

    # e: ex4 a at cl_k 5 by the step-clamped DOP853.
    proj = seq_prob_projector(list(SEQS.values()), 9, STEP_CL_K)
    p0 = chemical_turing_p0(STEP_CL_K, powered_fraction=0.04).ravel()

    def step_solve():
        return markov_tapes.ode_integrate_ivp(
            tag=EX4, size_a=9, cl_k=STEP_CL_K, p0=p0,
            ts=np.linspace(0.0, T_END, N_SAMPLES), backend="torch",
            device=dev, ivp_kwargs=dict(rtol=SOLVE_TOL, atol=SOLVE_TOL,
                                        method="dop853-step", project=proj,
                                        return_info=True))

    (obs, info), seconds, launches, k6, host_us = counted_path(
        "e", step_solve, ("K5", "K6"))
    k6_steps_say("e", info, k6, 12)
    final = dict(zip(SEQS, obs[-1].tolist()))
    rel = max(abs(final[m] / ORACLE_A[m] - 1) for m in ORACLE_A)
    if not rel <= ORACLE_REL:
        raise AssertionError(f"path e: {final}, rel {rel} from the oracle")
    record("e", launches, seconds=seconds, accepted=info["num_accepted"],
           rejected=info["num_rejected"], rhs=info["num_rhs"], oracle_rel=rel,
           k6_launches=k6, k6_host_us_per_launch=host_us)
    say(f"path e: ex4 a cl_k {STEP_CL_K} by dop853-step at {SOLVE_TOL:g}: {seconds:.2f} "
        f"s, {info['num_accepted']} accepted, {info['num_rejected']} "
        f"rejected (the dense stepper: {DENSE_STEPS_A}), {info['num_rhs']} "
        f"RHS; launches {launches}, K6 {k6}; host us a K6 launch "
        f"{({k: round(v, 2) for k, v in host_us.items()})}; observables "
        f"{rel:.3e} rel from the oracle (within {ORACLE_REL:g})")

    dp5_launches = sum(paths[x]["launches"]["K6"] for x in ("a", "b", "d",
                                                            "e"))
    for name, t in k6_dp5.items():
        say(f"K6 dopri5 {name} at {4**LOOSE_RUNS[0][2]} states: "
            f"{t['ms'] * 1e3:.2f} us against a bound of "
            f"{t['bound_ms'] * 1e3:.2f} us; plain {t['plain_ms'] * 1e3:.1f} "
            f"us; library " + (f"{t['library_ms'] * 1e3:.2f} us "
                               "(torch.addmv)" if t["library_ms"] is not None else "none")
            + f"; host {t['host_us_per_launch']:.2f} us a launch")
    say(f"K9 at ex6-self ({k9_self['worlds']} worlds, chains of "
        f"{k9_self['chain']}): {k9_self['ms'] * 1e3:.2f} us against a bound "
        f"of {k9_self['bound_ms'] * 1e3:.3f} us; plain "
        f"{k9_self['plain_ms'] * 1e3:.1f} us; host "
        f"{k9_self['host_us_per_launch']:.2f} us a launch")
    stage = k6_dp5["stage (B5)"]
    kernels["K6 dopri5"] = {
        "name": K6_DP5[0], "route": "cuda", "source": K6_DP5[1],
        "replaces": K6_DP5[2], "launches": dp5_launches, "max_abs_err": 0.0,
        "ms": stage["ms"], "plain_ms": stage["plain_ms"],
        "bound_ms": stage["bound_ms"], "bound_by": "bytes",
        "library_ms": stage["library_ms"],
        "shape": f"ex3var2 cl_k 8 ({4**8} states), the B5 stage",
        "functions": k6_dp5, "paths": paths}
    kernels["K9"] = {
        "name": K9[0], "route": "cuda", "source": K9[1], "replaces": K9[2],
        "launches": totals["K9"], "max_abs_err": 0.0, "ms": k9_self["ms"],
        "plain_ms": k9_self["plain_ms"], "bound_ms": k9_self["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "rule": SRC + "mass_rule.cuh",
        "shape": f"ex6-mini-bff-self cl_k 3 ({k9_self['worlds']} worlds, "
                 f"chains of {k9_self['chain']})",
        "host_us_per_launch": k9_self["host_us_per_launch"]}


# --- Phase 9: the rolled lattice rounds (K10-K13) against exact answers -------

LATTICE_ROUNDS = 200
# Machines phase 9 runs beside phase 3's (their K1 and K11 units built
# in phase 2).
LATTICE_TAGS = ["ex3-copolymerization"]
WIDE_E = L // 128  # stride 128, above the plane path's 64
EX2, EX3 = "ex2-ferromagnetic-chain", "ex3-copolymerization"
LATTICE_WRAPPERS = {"K10": ens.table_round, "K11": ens.lattice_round,
                    "K12": ens.pattern_scan,
                    "K13": ens.weighted_window_counts}
LATTICE_PLAIN = [ens.table_round_plain, ens.lattice_round_plain,
                 ens.pattern_scan_plain, ens.weighted_window_counts_plain,
                 ens.plane_round_plain, ens.window_counts_plain]
LATTICE_KERNELS = {
    "K10": ("K10 table_round", SRC + "table_round.cu",
            "the JAX package's engine/ensemble.py:927 _apply_lattice_round "
            "(XLA)"),
    "K11": ("K11 lattice_round", SRC + "lattice_round.cuh",
            "the JAX package's engine/ensemble.py:989 "
            "_apply_lattice_round_fsm, :913 _roll_cols, :1229 _roll_rows "
            "(XLA)"),
    "K12": ("K12 pattern_scan", SRC + "pattern_scan.cu",
            "the JAX package's engine/ensemble.py:1533 contains_pattern, "
            ":2750 pattern_progress, the t_hit update of "
            ":1580-1589 first_passage_times (XLA)"),
    "K13": ("K13 weighted_window_counts", SRC + "weighted_counts.cu",
            "the JAX package's engine/ensemble.py:2904 "
            "weighted_window_counts (XLA)"),
}
# The gates' tolerance: |z| below this, as the JAX package's
# tests/test_master.py and the examples hold them.
Z_GATE = 6.0
EX2FP = dict(cl_k=6, p_pair=0.02, B=4096, L=128, E=4, rounds=4800,
             pattern=(1, 1, 1, 1), seeds=12)
EX4IG = dict(cl_k=4, pf=0.16, cursor=0.02, B=4096, L=128, E=4,
             t_max=60.0, sym_x=7, seeds=8)


def fuzz_program(rng, size_a, depth):
    """The fuzz statement grammar of the JAX package's tests
    (tests/test_fuzz.py:31 `_gen_program`), which its master-equation
    gates register as rules: the same program from the same seed."""
    n = rng.randint(1, 3)
    prog = []
    for _ in range(n):
        kind = rng.choice(["get_branch", "set", "choose_branch", "copy"]
                          if depth > 0 else ["set", "copy"])
        tape = bool(rng.randint(2))
        idx = int(rng.randint(-1, 3))
        if kind == "get_branch":
            prog.append(("get_branch", tape, idx,
                         [fuzz_program(rng, size_a, depth - 1)
                          for _ in range(size_a)]))
        elif kind == "choose_branch":
            n_opts = int(rng.randint(2, 4))
            w = rng.rand(n_opts) + 0.1
            prog.append(("choose_branch", tuple(w / w.sum()),
                         [fuzz_program(rng, size_a, depth - 1)
                          for _ in range(n_opts)]))
        elif kind == "set":
            prog.append(("set", tape, idx, int(rng.randint(size_a))))
        else:
            src = bool(rng.randint(2))
            prog.append(("copy", src, idx, not src,
                         int(rng.randint(-1, 2))))
    return prog


def run_fuzz_program(t, prog, size_a):
    """tests/test_fuzz.py:64 `_run_program`."""
    for stmt in prog:
        if stmt[0] == "get_branch":
            run_fuzz_program(t, stmt[3][t.get(stmt[1], stmt[2])], size_a)
        elif stmt[0] == "choose_branch":
            k = t.vector_choose(list(stmt[1]), list(range(len(stmt[2]))))
            run_fuzz_program(t, stmt[2][k], size_a)
        elif stmt[0] == "set":
            t.set(stmt[1], stmt[2], stmt[3])
        else:
            _, src, idx, dst, didx = stmt
            t.set(dst, idx + didx, (t.get(src, idx) + 1) % size_a)


def pin_data(stmts):
    """tests/test_master.py:170-183: the program onto the data tape."""
    out = []
    for s in stmts:
        if s[0] == "get_branch":
            out.append((s[0], True, s[2], [pin_data(b) for b in s[3]]))
        elif s[0] == "choose_branch":
            out.append((s[0], s[1], [pin_data(b) for b in s[2]]))
        elif s[0] == "set":
            out.append((s[0], True, s[2], s[3]))
        else:
            out.append((s[0], True, s[2], True, s[4]))
    return out


def register_fuzz(seed, size_a, single_tape):
    """The JAX package's fuzz rule of ``seed`` in the port's registry:
    `_fuzz-master-*` (single tape, tests/test_master.py:161) or `_fuzz-*`
    (two tapes, tests/test_fuzz.py:83)."""
    if single_tape:
        tag = f"_fuzz-master-{size_a}-{seed}"
        prog = pin_data(fuzz_program(np.random.RandomState(7000 + seed),
                                     size_a, 2))
    else:
        tag = f"_fuzz-{size_a}-{seed}"
        prog = fuzz_program(np.random.RandomState(seed), size_a, 2)
    if tag not in tdsl.registered_problems():
        def rule(t, prog=prog, size_a=size_a):
            run_fuzz_program(t, prog, size_a)

        tdsl.register_problem(
            tag, tuple(f"S{i}" for i in range(size_a)))(rule)
    return tag


def zero_lattice_counts():
    for f in LATTICE_WRAPPERS.values():
        f.launches = 0
    ens.plane_round.launches = 0
    ens.window_counts.launches = 0
    for f in LATTICE_PLAIN:
        f.calls = 0


def lattice_path(label, fn, need, totals):
    """Runs the main path ``fn`` with every count set to 0 just before and
    read just after; raises unless each kernel of ``need`` launched and
    no plain version ran; adds K10-K13's launches to ``totals``. Returns
    (fn's result, seconds, launches, device ms by CUDA events)."""
    zero_lattice_counts()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in LATTICE_WRAPPERS.items()}
    launches["K1"] = ens.plane_round.launches
    plain = sum(f.calls for f in LATTICE_PLAIN)
    if plain or any(launches[k] == 0 for k in need):
        raise AssertionError(f"path {label}: launches {launches}, plain "
                             f"calls {plain}")
    for k in LATTICE_WRAPPERS:
        totals[k] = totals.get(k, 0) + launches[k]
    return result, seconds, launches, start.elapsed_time(end)


def lattice_say(label, what, seconds, rounds, launches, extra=""):
    say(f"path {label}: {what}: {seconds:.3f} s, "
        f"{rounds / seconds:.1f} rounds/s; launches "
        f"{({k: v for k, v in launches.items() if v})}{extra}")


def active_tapes(gen, tag, size_a, batch, length, dev):
    p_sym, d_sym = ACTIVE_SYMBOLS.get(tag, (range(size_a),) * 2)
    out = []
    for sym in (p_sym, d_sym):
        sym = torch.as_tensor(list(sym), dtype=torch.int32, device=dev)
        out.append(sym[torch.randint(0, len(sym), (batch, length),
                                     generator=gen, device=dev)])
    return out


def chunk_launches(rounds, per, resident):
    """Launches of a run of ``rounds`` rounds whose draws come ``per``
    rounds a chunk, a chunk a C call: one a call where the call is
    resident (``resident`` and at least `ensemble.K11_RESIDENT_MIN_ROUNDS`
    rounds), else one a round."""
    calls = [min(per, rounds - k0) for k0 in range(0, rounds, per)]
    return sum(1 if resident and n >= ens.K11_RESIDENT_MIN_ROUNDS else n
               for n in calls)


def table_launches(B_, L_, E_, rounds):
    """K10's launches in a `run_ensemble` of a table: its draws in chunks
    of at most `ensemble._TABLE_CHUNK` uniforms (`chunk_launches`)."""
    per = max(1, min(rounds, ens._TABLE_CHUNK // (B_ * E_)))
    return chunk_launches(rounds, per, ens.k10_tile(B_, L_, E_) is not None)


def table_call_bytes(dt, B_, L_, E_, n):
    """Least bytes of a resident K10 call of n rounds: both int32 rows of
    every member in and out once, a shift a round and, where the table
    has more than one outcome a row, a uniform a site and round; the
    table read once."""
    u = (dt.out_cum.element_size() * B_ * E_ if dt.out_cum.shape[1] > 1
         else 0)
    table = sum(t.numel() * t.element_size()
                for t in (dt.out_cum, dt.out_world, dt.wr_mask, dt.wr_val))
    return n * (u + 4) + 16 * B_ * L_ + table


def table_bytes_k10(dt, events, batch=B):
    """Least bytes a K10 round moves: every window cell read (4 B), the
    cells some spec writes written (4 B), a uniform a site where the
    table has more than one outcome a row (with one, the slot is always
    0 and no uniform is needed), the table read once."""
    written = int(dt.wr_mask.any(dim=0).sum())
    table = sum(t.numel() * t.element_size()
                for t in (dt.out_cum, dt.out_world, dt.wr_mask, dt.wr_val))
    uniform = dt.out_cum.element_size() if dt.out_cum.shape[1] > 1 else 0
    return (batch * events * (4 * dt.n_cells + 4 * written + uniform)
            + table)


def weighted_yardstick(tape, w, size_a, cl_k):
    """The bins and weights of `torch.bincount`'s weighted sum: each
    counted window's bin (`yardstick_ranks`) with its member's weight."""
    rank, keep = yardstick_ranks(tape, size_a, cl_k)
    return rank[keep], w[:, None].expand(tape.shape)[keep]


def z_of(reps, want, floor=None):
    reps = np.stack(reps)
    sem = reps.std(axis=0, ddof=1) / np.sqrt(len(reps))
    scale = np.maximum(sem, 1e-6 if floor is None else floor)
    return float((np.abs(reps.mean(axis=0) - want) / scale).max())


def survival_z(curves, S_exact, batch):
    curves = np.stack(curves)
    sem = curves.std(axis=0, ddof=1) / np.sqrt(len(curves))
    floor = np.sqrt(np.maximum(S_exact * (1 - S_exact), 1e-9)
                    / (len(curves) * batch))
    return float((np.abs(curves.mean(axis=0) - S_exact)
                  / np.maximum(sem, floor)).max())


def first_passage_plain(dm, tapes, pattern, shifts, events, uniforms,
                        data_tape):
    """`first_passage_from_draws` written out with the plain versions on
    the tapes' device: the scan at t = 0, then a `lattice_round_plain`
    and a `pattern_scan_plain` (mode 2) a round."""
    pt, dt = (t.to(torch.int8).clone() for t in tapes)
    dev = pt.device
    pat = torch.tensor(pattern, dtype=torch.int32, device=dev)
    times = torch.arange(shifts.shape[0] + 1, dtype=torch.float64,
                         device=dev) * -math.log1p(-events / pt.shape[1])
    t_hit = torch.full((pt.shape[0],), math.inf, dtype=torch.float64,
                       device=dev)
    watch = dt if data_tape else pt
    ens.pattern_scan_plain(watch, pat, 2, t_hit=t_hit, t_now=times[:1])
    for k in range(shifts.shape[0]):
        ens.lattice_round_plain(dm, pt, dt, shifts[k], events,
                                None if uniforms is None else uniforms[k])
        ens.pattern_scan_plain(watch, pat, 2, t_hit=t_hit,
                               t_now=times[k + 1:k + 2])
    return t_hit, torch.isfinite(t_hit), (pt.to(torch.int32),
                                          dt.to(torch.int32))


def first_passage_against_plain(label, dm, tapes, pattern, plan, per_call,
                                data_tape, gen, diff, need_late=True):
    """K11 and K12 as a first-passage run sends them (``per_call``
    rounds a C call) against `first_passage_plain` at the same draws:
    hit times, hits and both tapes bit for bit, and one K11 launch a C
    call (one a round where the rows are too long to keep resident).
    With ``need_late``, raises unless some member hits after t = 0 and
    some never does, so the times are compared where they change.
    Returns (K11 launches, C calls)."""
    rounds, events = plan
    B, L = tapes[0].shape
    dev = tapes[0].device
    shifts = torch.randint(0, L, (rounds,), generator=gen, device=dev,
                           dtype=torch.int32)
    u = (torch.rand((rounds, B, events), generator=gen, device=dev)
         if dm.has_choose else None)
    k11 = ens.lattice_round.launches
    got = ens.first_passage_from_draws(dm, tapes, pattern, shifts, events,
                                       u, data_tape=data_tape,
                                       rounds_per_call=per_call)
    k11 = ens.lattice_round.launches - k11
    want = first_passage_plain(dm, tapes, pattern, shifts, events, u,
                               data_tape)
    torch.cuda.synchronize()
    t_k, h_k, (p_k, d_k) = got
    t_p, h_p, (p_p, d_p) = want
    same_t = torch.equal(t_k, t_p) and torch.equal(h_k, h_p)
    if not (same_t and diff("K11", ((p_k, p_p), (d_k, d_p)))):
        raise AssertionError(f"{label}: first passage on the card != the "
                             "plain loop")
    diff("K12", ((h_k, h_p), (t_k.nan_to_num(posinf=-1.0),
                              t_p.nan_to_num(posinf=-1.0))))
    calls = -(-rounds // (per_call or rounds))
    resident = ens.k11_tile(B, L, events, len(pattern)) is not None
    if k11 != (calls if resident else rounds):
        raise AssertionError(f"{label}: {k11} K11 launches for {calls} C "
                             f"calls of {rounds} rounds")
    late = int((h_p & (t_p > 0)).sum())
    if need_late and not (late and int(h_p.sum()) < B):
        raise AssertionError(f"{label}: {late} members hit after t = 0, "
                             f"{int(h_p.sum())} of {B} in all")
    say(f"{label}: first_passage_from_draws at B={B}, L={L}, E={events}, "
        f"{rounds} rounds in calls of {per_call} == the plain loop (hit "
        f"times, hits, both tapes), bit for bit; {int(h_p.sum())} hits, "
        f"{late} after t = 0; {k11} K11 launches "
        + ("(resident: one a C call)" if resident else "(rows too long to "
           "keep resident: one a round)"))
    return k11, calls


def weighted_against_plain(label, tapes, w, size_a, cl_k, diff):
    """K13 twice on each of ``tapes`` against its plain version, bit for
    bit."""
    for tape in tapes:
        want = ens.weighted_window_counts_plain(tape, w / w.sum(), size_a,
                                                cl_k)
        got = [ens.weighted_window_counts(tape, w, size_a, cl_k,
                                          device=tape.device)
               for _ in range(2)]
        torch.cuda.synchronize()
        if not diff("K13", [(g_, want) for g_ in got]):
            raise AssertionError(f"{label}: K13 != plain")
    say(f"{label}: K13 == plain on {len(tapes)} tapes of "
        f"{list(tapes[0].shape)} ({size_a**cl_k} bins), twice, bit for bit")


def master_gates(dev, gen, totals, record, diff):
    """(d): the master-equation gates of the JAX package's
    tests/test_master.py on the card, at their settings and gates, with
    the port's master equation as the oracle."""
    # :75, the ensemble dynamics: ex2, L=12, E=1, 18 rounds (shared
    # sites: K1's plane path), 16 runs of 512, K13's marginals.
    size_a, cl_k, Lm, rounds = 2, 3, 12, 18
    spd = np.asarray(ferromagnet_p0(cl_k, p_pair=0.1)).reshape((2,) * cl_k)
    p0 = tmaster.ring_trace_measure(spd, size_a, cl_k, Lm)
    Q = tmaster.build_ring_generator(EX2, Lm)
    t_end = rounds * -math.log1p(-1 / Lm)
    want = tmaster.state_window_marginals(
        tmaster.solve_master(Q, p0, [0.0, t_end])[-1], Lm, size_a, cl_k)
    dm2 = ens.compile_decision_machine(EX2)
    ones = torch.full((512,), 1 / 512, dtype=torch.float64, device=dev)

    seen = []

    def dynamics():
        reps = []
        for _ in range(16):
            d = ens.sample_tapes_from_spd(gen, spd, size_a, cl_k, 512, Lm,
                                          ring=True, device=dev)
            (_, d), _ = ens.run_ensemble(
                gen, (torch.zeros_like(d), d), dm2, (rounds, 1),
                bitslice=False, device=dev)
            seen.append(d)
            reps.append(ens.weighted_window_counts(d, ones, size_a, cl_k,
                                                   device=dev).cpu().numpy())
        return reps

    reps, sec, la, _ = lattice_path("d:75", dynamics, ("K1", "K13"), totals)
    weighted_against_plain("d:75", seen, ones, size_a, cl_k, diff)
    z = z_of(reps, want)
    moved = float(np.abs(want - tmaster.state_window_marginals(
        p0, Lm, size_a, cl_k)).max())
    if not (z < Z_GATE and moved > 1e-3):
        raise AssertionError(f"test_master.py:75 gate: z {z}, moved {moved}")
    record("d:75", la, seconds=sec, z=z)
    lattice_say("d:75", "ex2 ensemble dynamics against the master equation "
                f"(z {z:.2f} < {Z_GATE})", sec, 16 * rounds, la)

    # :248, seed 0: a random single-tape rule, independent sites (K11).
    tag = register_fuzz(0, 2, True)
    dmf = ens.compile_decision_machine(tag)
    Q = tmaster.build_ring_generator(tag, Lm)
    p = np.full(2**Lm, 1.0 / 2**Lm)
    for _ in range(12):
        p = p + (Q @ p) / Lm
    want = tmaster.state_window_marginals(p, Lm, 2, 3)

    def fuzz():
        reps = []
        for _ in range(8):
            d = torch.randint(0, 2, (512, Lm), generator=gen, device=dev,
                              dtype=torch.int32)
            (_, d), _ = ens.run_ensemble(gen, (torch.zeros_like(d), d), dmf,
                                         (12, 1), independent_sites=True,
                                         device=dev)
            reps.append(ens.weighted_window_counts(d, ones, 2, 3,
                                                   device=dev).cpu().numpy())
        return reps

    reps, sec, la, _ = lattice_path("d:248", fuzz, ("K11", "K13"), totals)
    floor = np.sqrt(np.maximum(want, 1e-9) * np.clip(1 - want, 0, 1)
                    / (8 * 512 * Lm / 3))
    z = z_of(reps, want, floor)
    if not (z < Z_GATE and np.stack(reps).mean(0)[want > 1e-3].min() > 0):
        raise AssertionError(f"test_master.py:248 gate (seed 0): z {z}")
    record("d:248", la, seconds=sec, z=z)
    lattice_say("d:248", f"fuzz rule seed 0, independent sites (z {z:.2f})",
                sec, 8 * 12, la)

    # :323, seed 702 at L=10: a two-tape rule through its transition
    # table (its machine's 155 write specs are beyond K11's unit),
    # independent sites (K10), joint windows.
    tag = register_fuzz(702, 2, False)
    dtf = ens.device_table(ens.compile_transition_table(tag), device=dev)
    Lp = 10
    t0 = time.perf_counter()
    Q = tmaster.build_pair_ring_generator(tag, Lp)
    S = 2 ** (2 * Lp)
    p = np.full(S, 1.0 / S)
    for _ in range(12):
        p = p + (Q @ p) / Lp
    want = tmaster.pair_state_window_marginals(p, Lp, 2, 3)
    host_s = time.perf_counter() - t0

    def pair():
        reps = []
        for _ in range(8):
            pt = torch.randint(0, 2, (512, Lp), generator=gen, device=dev,
                               dtype=torch.int32)
            dt = torch.randint(0, 2, (512, Lp), generator=gen, device=dev,
                               dtype=torch.int32)
            (pt, dt), _ = ens.run_ensemble(gen, (pt, dt), dtf, (12, 1),
                                           independent_sites=True,
                                           device=dev)
            reps.append(ens.weighted_window_counts(
                pt * 2 + dt, ones, 4, 3, device=dev).cpu().numpy())
        return reps

    reps, sec, la, _ = lattice_path("d:323", pair, ("K10", "K13"), totals)
    floor = np.sqrt(np.maximum(want, 1e-9) * np.clip(1 - want, 0, 1)
                    / (8 * 512 * Lp / 3))
    z = z_of(reps, want, floor)
    if not z < Z_GATE:
        raise AssertionError(f"test_master.py:323 gate (seed 702): z {z}")
    record("d:323", la, seconds=sec, z=z, master_host_s=host_s)
    lattice_say("d:323", f"two-tape fuzz seed 702 by its table, independent "
                f"sites (z {z:.2f}; the pair master equation {host_s:.1f} s "
                "of host)", sec, 8 * 12, la)

    # :396, ex3 on an L=5 ring, one round from a concrete pair (K11).
    dm3 = ens.compile_decision_machine(EX3)
    Q3 = tmaster.build_pair_ring_generator(EX3, 5).tocsc()
    xp = torch.tensor([0, 1, 0, 0, 0], dtype=torch.int32, device=dev)
    xd = torch.tensor([0, 2, 0, 0, 0], dtype=torch.int32, device=dev)
    x = 0
    for v in [0, 1, 0, 0, 0, 0, 2, 0, 0, 0]:
        x = x * 4 + v
    (pt2, dt2), sec, la, _ = lattice_path(
        "d:396", lambda: ens.run_ensemble(
            gen, (xp.repeat(4096, 1), xd.repeat(4096, 1)), dm3, (1, 1),
            independent_sites=True, device=dev)[0], ("K11",), totals)
    ranks = np.zeros(4096, np.int64)
    for tape in (pt2.cpu().numpy(), dt2.cpu().numpy()):
        for i in range(5):
            ranks = ranks * 4 + tape[:, i]
    emp = np.bincount(ranks, minlength=4**10) / 4096
    col = np.zeros(4**10)
    col[x] = 1.0
    col += np.asarray(Q3[:, x].todense()).ravel() / 5
    tv = 0.5 * float(np.abs(emp - col).sum())
    if not (tv < 0.05 and col[x] < 1.0):
        raise AssertionError(f"test_master.py:396 gate: tv {tv}")
    record("d:396", la, seconds=sec, tv=tv)
    lattice_say("d:396", f"ex3 at L=5, E=1 (total variation {tv:.4f} < "
                "0.05)", sec, 1, la)

    # :441, first passage on ex2 (K11 and K12).
    pattern, rounds = (1, 1, 1), 60
    spd = np.asarray(ferromagnet_p0(cl_k, p_pair=0.3)).reshape((2,) * cl_k)
    p0 = tmaster.ring_trace_measure(spd, 2, cl_k, Lm)
    hit = tmaster.ring_contains_pattern(Lm, 2, pattern)
    S_exact = tmaster.discrete_survival(tmaster.build_ring_generator(EX2, Lm),
                                        p0, hit, rounds, Lm)
    dt_round = -math.log1p(-1 / Lm)

    def passage():
        curves = []
        for _ in range(16):
            d = ens.sample_tapes_from_spd(gen, spd, 2, cl_k, 512, Lm,
                                          ring=True, device=dev)
            t_hit, _, _ = ens.first_passage_times(
                gen, (torch.zeros_like(d), d), dm2, pattern, (rounds, 1),
                device=dev)
            t_hit = t_hit.cpu().numpy()
            curves.append([float((t_hit >= dt_round * (r + 0.5)).mean())
                           for r in range(rounds + 1)])
        return curves

    curves, sec, la, _ = lattice_path("d:441", passage, ("K11", "K12"),
                                      totals)
    z = survival_z(curves, S_exact, 512)
    if not (z < Z_GATE and S_exact[-1] < 0.85):
        raise AssertionError(f"test_master.py:441 gate: z {z}")
    record("d:441", la, seconds=sec, z=z)
    lattice_say("d:441", f"ex2 first passage against the absorbing master "
                f"equation (z {z:.2f})", sec, 16 * rounds, la)

    # :497, two-tape first passage on ex3 at L=5 (K11 and K12).
    p_prog = torch.tensor([0.6, 0.4, 0.0, 0.0], dtype=torch.float64)
    p_data = torch.tensor([0.7, 0.0, 0.3, 0.0], dtype=torch.float64)
    digits = tmaster._ring_digits(5, 4)

    def iid_ring(probs):
        w = np.ones(4**5)
        for i in range(5):
            w = w * probs.numpy()[digits[:, i]]
        return w

    p0 = np.kron(iid_ring(p_prog), iid_ring(p_data))
    hit = tmaster.pair_ring_contains_pattern(5, 4, (1, 2))
    S_exact = tmaster.discrete_survival(
        tmaster.build_pair_ring_generator(EX3, 5), p0, hit, 60, 5)
    dt_round = -math.log1p(-1 / 5)

    def pair_passage():
        curves = []
        for _ in range(16):
            pt = torch.multinomial(p_prog.to(dev), 512 * 5, True,
                                   generator=gen).view(512, 5)
            dt = torch.multinomial(p_data.to(dev), 512 * 5, True,
                                   generator=gen).view(512, 5)
            t_hit, _, _ = ens.first_passage_times(gen, (pt, dt), dm3, (1, 2),
                                                  (60, 1), device=dev)
            t_hit = t_hit.cpu().numpy()
            curves.append([float((t_hit >= dt_round * (r + 0.5)).mean())
                           for r in range(61)])
        return curves

    curves, sec, la, _ = lattice_path("d:497", pair_passage, ("K11", "K12"),
                                      totals)
    z = survival_z(curves, S_exact, 512)
    if not (z < Z_GATE and 0.02 < 1 - S_exact[-1] < 0.9):
        raise AssertionError(f"test_master.py:497 gate: z {z}")
    record("d:497", la, seconds=sec, z=z)
    lattice_say("d:497", f"ex3 first A-M bond against the pair kernel "
                f"(z {z:.2f})", sec, 16 * 60, la)


def example_runs(dev, gen, totals, record, diff):
    """(e): the examples' ensemble runs at their settings."""
    # examples/ex2_master_oracle.py: B=8192, L=12, E=1, 24 snapshots of 2
    # rounds, independent sites; p(DUD) at every snapshot within its gate.
    Bm, Lm, snaps, per = 8192, 12, 24, 2
    spd = np.asarray(ferromagnet_p0(5, p_pair=0.1)).reshape((2,) * 5)
    ts = np.arange(snaps + 1) * per * -math.log1p(-1 / Lm)
    p_states = tmaster.solve_master(tmaster.build_ring_generator(EX2, Lm),
                                    tmaster.ring_trace_measure(spd, 2, 5,
                                                               Lm), ts)
    dud = 0 * 4 + 1 * 2 + 0
    exact = np.array([tmaster.state_window_marginals(p, Lm, 2, 3)[dud]
                      for p in p_states])
    dm2 = ens.compile_decision_machine(EX2)
    w = torch.full((Bm,), 1 / Bm, dtype=torch.float64, device=dev)

    seen = []

    def oracle_run():
        d = ens.sample_tapes_from_spd(gen, spd, 2, 5, Bm, Lm, ring=True,
                                      device=dev)
        pt = torch.zeros_like(d)
        seen.append(d)
        out = [ens.weighted_window_counts(d, w, 2, 3, device=dev)[dud]]
        for _ in range(snaps):
            (pt, d), _ = ens.run_ensemble(gen, (pt, d), dm2, (per, 1),
                                          independent_sites=True,
                                          device=dev)
            seen.append(d)
            out.append(ens.weighted_window_counts(d, w, 2, 3,
                                                  device=dev)[dud])
        return torch.stack(out).cpu().numpy()

    emp, sec, la, _ = lattice_path("e:ex2_master_oracle", oracle_run,
                                   ("K11", "K13"), totals)
    weighted_against_plain("e:ex2_master_oracle", seen, w, 2, 3, diff)
    se = np.sqrt(np.maximum(exact, 1e-9) / (Bm * Lm / 3))
    z = float((np.abs(emp - exact) / np.maximum(se, 1e-9)).max())
    if not z < Z_GATE:
        raise AssertionError(f"ex2_master_oracle: max z {z}")
    record("e:ex2_master_oracle", la, seconds=sec, z=z)
    lattice_say("e:ex2_master_oracle", f"{snaps + 1} snapshots of p(DUD) "
                f"(max z {z:.2f} < {Z_GATE})", sec, snaps * per, la)

    # examples/ex2_first_passage.py: its run on several generator seeds,
    # the committed artifact held to them.
    c = EX2FP
    p0 = np.asarray(ferromagnet_p0(c["cl_k"], p_pair=c["p_pair"],
                                   corrected=True)).ravel()

    def fp_runs():
        out = []
        for s in range(c["seeds"]):
            g = torch.Generator(device=dev).manual_seed(4000 + s)
            d = ens.sample_tapes_from_spd(g, p0, 2, c["cl_k"], c["B"],
                                          c["L"], device=dev)
            out.append(ens.first_passage_times(
                g, (torch.zeros_like(d), d), dm2, c["pattern"],
                (c["rounds"], c["E"]), device=dev)[0].cpu().numpy())
        return out

    runs, sec, la, _ = lattice_path("e:ex2_first_passage", fp_runs,
                                    ("K11", "K12"), totals)
    z, mean, sd, art = artifact_z("ex2_first_passage.npz", runs)
    record("e:ex2_first_passage", la, seconds=sec, z=z.tolist(),
           seeds_mean=mean.tolist(), seeds_sd=sd.tolist(),
           artifact=art.tolist())
    lattice_say("e:ex2_first_passage", f"{c['seeds']} seeds of {c['B']} x "
                f"{c['rounds']} rounds; hit fraction and quartiles "
                f"{np.round(mean, 4).tolist()} (sd {np.round(sd, 4).tolist()})"
                f", the artifact's {np.round(art, 4).tolist()}, z "
                f"{np.round(z, 2).tolist()}", sec, c["seeds"] * c["rounds"],
                la)
    d = ens.sample_tapes_from_spd(gen, p0, 2, c["cl_k"], c["B"], c["L"],
                                  device=dev)
    fp_calls = [first_passage_against_plain(
        "e:ex2_first_passage", dm2, (torch.zeros_like(d), d), c["pattern"],
        (600, c["E"]), 250, True, gen, diff)]

    # examples/ex4_ignition.py's first_passage_times call (first X on the
    # program tape) on several seeds: the committed artifact held to them,
    # and their pooled survival curve on the lattice closed form within
    # the example's own gate (0.02).
    c = EX4IG
    rounds = int(round(c["t_max"] / -math.log1p(-c["E"] / c["L"])))
    p_fuel = chemical_turing_p0(c["cl_k"], tape_fraction=0.0,
                                powered_fraction=c["pf"]).reshape(
        (9,) * c["cl_k"])
    p_tape = chemical_turing_p0(c["cl_k"], tape_fraction=1.0,
                                cursor_fraction=c["cursor"],
                                random01=True).reshape((9,) * c["cl_k"])
    p_fire = sum(float(np.squeeze(tmarkov.seq_prob(p_tape, (0, b1, b2))[0]))
                 for b1 in (4, 5) for b2 in (4, 5))
    a = p_fire * float(np.squeeze(tmarkov.seq_prob(p_fuel, (6,))[0]))
    dm4 = ens.compile_decision_machine(EX4)

    def ignition():
        out = []
        for s in range(c["seeds"]):
            g = torch.Generator(device=dev).manual_seed(5000 + s)
            pt = ens.sample_tapes_from_spd(g, p_fuel, 9, c["cl_k"], c["B"],
                                           c["L"], ring=True, device=dev)
            dt = ens.sample_tapes_from_spd(g, p_tape, 9, c["cl_k"], c["B"],
                                           c["L"], ring=True, device=dev)
            out.append(ens.first_passage_times(
                g, (pt, dt), dm4, (c["sym_x"],), (rounds, c["E"]),
                data_tape=False, device=dev)[0].cpu().numpy())
        return out

    runs, sec, la, _ = lattice_path("e:ex4_ignition", ignition,
                                    ("K11", "K12"), totals)
    z, mean, sd, art = artifact_z("ex4_ignition.npz", runs)
    ts = np.linspace(0.0, c["t_max"], 300)
    pooled = np.concatenate(runs)
    surv = np.array([(pooled > t).mean() for t in ts])
    dev_max = float(np.abs(surv - (1 - a + a * np.exp(-0.5 * ts)) ** c["L"])
                    .max())
    if not dev_max < 0.02:
        raise AssertionError(f"ex4_ignition: survival {dev_max} from the "
                             "closed form")
    record("e:ex4_ignition", la, seconds=sec, z=z.tolist(),
           seeds_mean=mean.tolist(), seeds_sd=sd.tolist(),
           artifact=art.tolist(), survival_dev=dev_max)
    lattice_say("e:ex4_ignition", f"{c['seeds']} seeds of {c['B']} x "
                f"{rounds} rounds; pooled survival within {dev_max:.4f} of "
                f"(1-a+a e^(-t/2))^L (gate 0.02); hit fraction and quartiles "
                f"{np.round(mean, 4).tolist()} (sd {np.round(sd, 4).tolist()})"
                f", the artifact's {np.round(art, 4).tolist()}, z "
                f"{np.round(z, 2).tolist()}", sec, c["seeds"] * rounds, la)
    tapes = [ens.sample_tapes_from_spd(gen, p, 9, c["cl_k"], c["B"], c["L"],
                                       ring=True, device=dev)
             for p in (p_fuel, p_tape)]
    fp_calls.append(first_passage_against_plain(
        "e:ex4_ignition", dm4, tapes, (c["sym_x"],), (300, c["E"]), 128,
        False, gen, diff))
    return fp_calls


def resident_checks(dev, gen, dm5, tab, diff):
    """(g): K11's resident rounds at the full width (shared and
    per-member shifts: one launch a call) and the fused first passage at
    the full width, each against its plain version; then a row too long
    to keep resident (2L past 227 KB: one launch a round), both ways."""
    start = [t.to(torch.int8) for t in tab]
    rounds = 8
    for shape in ((rounds,), (rounds, B)):
        s_ = torch.randint(0, L, shape, generator=gen, device=dev,
                           dtype=torch.int32)
        kp, kd = (t.clone() for t in start)
        k11 = ens.lattice_round.launches
        ens.run_lattice_rounds(dm5, kp, kd, s_, E)
        k11 = ens.lattice_round.launches - k11
        pp, pd = (t.clone() for t in start)
        for k in range(rounds):
            ens.lattice_round_plain(dm5, pp, pd, s_[k], E)
        torch.cuda.synchronize()
        if not (diff("K11", ((kp, pp), (kd, pd))) and k11 == 1):
            raise AssertionError(f"K11 resident != plain at B={B}, L={L}, "
                                 f"shifts {list(shape)} ({k11} launches)")
    say(f"K11 resident == lattice_round_plain at B={B}, L={L}, E={E}, "
        f"{rounds} rounds in one launch, shared and per-member shifts, bit "
        "for bit")
    dm2 = ens.compile_decision_machine(EX2)
    d = (torch.rand((B, L), generator=gen, device=dev) < 0.3).to(torch.int32)
    first_passage_against_plain(
        "(g) full width", dm2, (torch.zeros_like(d), d), (1,) * 12, (30, E),
        10, True, gen, diff)
    Ll, Bl, El = 131_072, 8, 16
    if ens.k11_tile(Bl, Ll, El) is not None:
        raise AssertionError("the long row was kept resident")
    lp, ld = active_tapes(gen, MAIN_TAG, 5, Bl, Ll, dev)
    lp, ld = lp.to(torch.int8), ld.to(torch.int8)
    s_ = torch.randint(0, Ll, (3, Bl), generator=gen, device=dev,
                       dtype=torch.int32)
    kp, kd = lp.clone(), ld.clone()
    k11 = ens.lattice_round.launches
    ens.run_lattice_rounds(dm5, kp, kd, s_, El)
    k11 = ens.lattice_round.launches - k11
    pp, pd = lp.clone(), ld.clone()
    for k in range(3):
        ens.lattice_round_plain(dm5, pp, pd, s_[k], El)
    torch.cuda.synchronize()
    if not (diff("K11", ((kp, pp), (kd, pd))) and k11 == 3):
        raise AssertionError(f"K11 at L={Ll} != plain ({k11} launches)")
    d = (torch.rand((Bl, Ll), generator=gen, device=dev) < 0.3).to(
        torch.int32)
    first_passage_against_plain(
        "(g) long rows", dm2, (torch.zeros_like(d), d), (1,) * 12, (6, 4),
        None, True, gen, diff, need_late=False)
    say(f"K11 at a row too long to keep resident (B={Bl}, L={Ll}, 2L = "
        f"{2 * Ll} bytes): one launch a round == plain, bit for bit, per-"
        "member shifts and first passage")


def table_resident_checks(dev, gen, tdt, tab, diff):
    """(g): K10's resident rounds (`run_lattice_rounds`: one launch a
    call) at the full width on ex5's table (one outcome a row) and ex4's
    (three, float64 uniforms that decide), shared and per-member shifts,
    then at a row too long to keep resident (B=8, L=32,768: one launch a
    round), each against the plain rounds bit for bit."""
    rounds = 6
    t4 = ens.device_table(ens.compile_transition_table(EX4), device=dev)
    t4p, t4d = active_tapes(gen, EX4, 9, B, L, dev)
    for name, dt_, start in (("ex5", tdt, tab), ("ex4", t4, (t4p, t4d))):
        for shape in ((rounds,), (rounds, B)):
            s_ = torch.randint(0, L, shape, generator=gen, device=dev,
                               dtype=torch.int32)
            u_ = torch.rand((rounds, B, E), generator=gen, device=dev,
                            dtype=torch.float64)
            kp, kd = (t.clone() for t in start)
            k10 = ens.table_round.launches
            ens.run_lattice_rounds(dt_, kp, kd, s_, E, u_)
            k10 = ens.table_round.launches - k10
            pp, pd = (t.clone() for t in start)
            for k in range(rounds):
                ens.table_round_plain(dt_, pp, pd, s_[k], u_[k])
            torch.cuda.synchronize()
            changed = int((kp != start[0]).sum() + (kd != start[1]).sum())
            if not (diff("K10", ((kp, pp), (kd, pd))) and k10 == 1
                    and changed):
                raise AssertionError(
                    f"K10 resident != plain on {name}'s table at B={B}, "
                    f"L={L}, shifts {list(shape)} ({k10} launches, "
                    f"{changed} cells changed)")
    del t4, t4p, t4d, kp, kd, pp, pd, u_
    say(f"K10 resident == table_round_plain at B={B}, L={L}, E={E}, "
        f"{rounds} rounds in one launch, ex5's and ex4's tables, shared and "
        "per-member shifts, bit for bit")
    Ll, Bl, El = 32_768, 8, 16
    if ens.k10_tile(Bl, Ll, El) is not None:
        raise AssertionError("K10: the long row was kept resident")
    lp, ld = active_tapes(gen, MAIN_TAG, 5, Bl, Ll, dev)
    s_ = torch.randint(0, Ll, (4, Bl), generator=gen, device=dev,
                       dtype=torch.int32)
    u_ = torch.rand((4, Bl, El), generator=gen, device=dev,
                    dtype=torch.float64)
    kp, kd = lp.clone(), ld.clone()
    k10 = ens.table_round.launches
    ens.run_lattice_rounds(tdt, kp, kd, s_, El, u_)
    k10 = ens.table_round.launches - k10
    pp, pd = lp.clone(), ld.clone()
    for k in range(4):
        ens.table_round_plain(tdt, pp, pd, s_[k], u_[k])
    torch.cuda.synchronize()
    if not (diff("K10", ((kp, pp), (kd, pd))) and k10 == 4):
        raise AssertionError(f"K10 at L={Ll} != plain ({k10} launches)")
    say(f"K10 at a row too long to keep resident (B={Bl}, L={Ll}): one "
        "launch a round == plain, bit for bit, per-member shifts")


def hit_stats(t_hit):
    """Hit fraction and the quartiles of the finite hit times."""
    fin = t_hit[np.isfinite(t_hit)]
    return np.array([np.isfinite(t_hit).mean(),
                     *np.quantile(fin, [0.25, 0.5, 0.75])])


def artifact_z(name, runs):
    """The committed run ``examples/<name>`` (its ``t_hit``) against the
    port's runs of the same settings on other seeds: each of `hit_stats`
    as a z against the seeds' mean and empirical scatter. Members of one
    run share each round's sites, so its members are not independent
    draws; the seeds are. The artifact is one run, so its difference from
    the seeds' mean has variance sd**2 (1 + 1/seeds). Raises unless every
    z is below Z_GATE."""
    art = hit_stats(np.load(EXAMPLES / name)["t_hit"])
    stats = np.stack([hit_stats(r) for r in runs])
    mean, sd = stats.mean(axis=0), stats.std(axis=0, ddof=1)
    z = np.abs(art - mean) / (sd * math.sqrt(1 + 1 / len(runs)))
    if not float(z.max()) < Z_GATE:
        raise AssertionError(f"{name}: z {z} (artifact {art}, seeds {mean} "
                             f"+- {sd})")
    return z, mean, sd, art


def lattice_phase(dev, kernels):
    """Phase 9 (module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(909)
    totals, paths = {}, {}
    max_err = dict.fromkeys(LATTICE_WRAPPERS, 0)

    def diff(name, pairs):
        """The largest difference of the kernel's outputs from the plain
        version's (``pairs``), kept for the kernels line."""
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        max_err[name] = max(max_err[name], err)
        return err == 0.0

    def record(label, launches, **kw):
        paths[label] = {"launches": {k: v for k, v in launches.items() if v},
                        **kw}

    say("K10, K12, K13 in the library built in phase 2; K11 in each "
        "machine's unit")
    dm5 = ens.compile_decision_machine(MAIN_TAG)
    tdt = ens.device_table(ens.compile_transition_table(MAIN_TAG), device=dev)
    ptape = torch.randint(0, 3, (B, L), generator=gen, device=dev,
                          dtype=torch.int32)
    dtape = torch.zeros((B, L), dtype=torch.int32, device=dev)

    def check_run(label, tapes, size_a):
        for t in tapes:
            if t.shape != (B, L) or t.dtype != torch.int32 or int(
                    t.min()) < 0 or int(t.max()) >= size_a:
                raise AssertionError(f"path {label}: tapes out of range")
        if int((tapes[1] != dtape).sum()) == 0:
            raise AssertionError(f"path {label}: the data tape never changed")

    # (a) A transition table at full width (K10: one resident launch a
    # chunk of draws).
    want10 = table_launches(B, L, E, LATTICE_ROUNDS)
    (tab, (_, times)), sec, la, ms = lattice_path(
        "a", lambda: ens.run_ensemble(gen, (ptape, dtape), tdt,
                                      (LATTICE_ROUNDS, E), device=dev),
        ("K10",), totals)
    if la["K10"] != want10 or la["K11"] or la["K1"]:
        raise AssertionError(f"path a: launches {la}, want K10 {want10}")
    check_run("a", tab, 5)
    record("a", la, seconds=sec, device_ms=ms)
    lattice_say("a", f"run_ensemble with ex5's table at B={B}, L={L}, E={E}",
                sec, LATTICE_ROUNDS, la,
                f"; {ms / LATTICE_ROUNDS * 1e3:.2f} us a round on the card "
                f"(draws and conversions included), "
                f"{B * E * LATTICE_ROUNDS / (ms * 1e-3):.4e} transitions/s")
    s1 = torch.randint(0, L, (1,), generator=gen, device=dev,
                       dtype=torch.int32)
    u64 = torch.rand((B, E), generator=gen, device=dev, dtype=torch.float64)
    kp, kd = tab[0].clone(), tab[1].clone()
    pp, pd = tab[0].clone(), tab[1].clone()
    ens.table_round(tdt, kp, kd, s1, u64)
    ens.table_round_plain(tdt, pp, pd, s1, u64)
    torch.cuda.synchronize()
    if not diff("K10", ((kp, pp), (kd, pd))):
        raise AssertionError("K10 != plain at explicit draws")
    u32 = torch.rand((B, E), generator=gen, device=dev)
    for shift in (s1, torch.randint(0, L, (B,), generator=gen, device=dev,
                                    dtype=torch.int32)):
        kp, kd = tab[0].clone(), tab[1].clone()
        mp, md = kp.to(torch.int8), kd.to(torch.int8)
        ens.table_round(tdt, kp, kd, shift, u32.double())
        ens.lattice_round(dm5, mp, md, shift, E, u32)
        torch.cuda.synchronize()
        if not (torch.equal(kp, mp.to(torch.int32))
                and torch.equal(kd, md.to(torch.int32))):
            raise AssertionError("K10 != K11 on ex5 at float32 uniforms")
    say("K10 == table_round_plain at explicit draws, bit for bit; K10 == "
        "K11 on ex5 at float32-exact uniforms (shared and per-member shifts)")
    # ex5's table has one outcome a row, so its uniforms never decide:
    # K10's compare and slot cap on tables where they do.
    own = torch.randint(0, L, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    for tag, size_a, dtype in ((EX4, 9, None), (EX3, 4, torch.float32)):
        mt = ens.device_table(ens.compile_transition_table(tag), dtype,
                              device=dev)
        tp, td = active_tapes(gen, tag, size_a, B, L, dev)
        u = torch.rand((B, E), generator=gen, device=dev,
                       dtype=mt.out_cum.dtype)
        for shift in (s1, own):
            kp, kd = tp.clone(), td.clone()
            pp, pd = tp.clone(), td.clone()
            ens.table_round(mt, kp, kd, shift, u)
            ens.table_round_plain(mt, pp, pd, shift, u)
            torch.cuda.synchronize()
            changed = int((kp != tp).sum() + (kd != td).sum())
            if not (diff("K10", ((kp, pp), (kd, pd))) and changed):
                raise AssertionError(f"K10 != plain on {tag}'s table "
                                     f"(changed {changed})")
        # The same round with every uniform 0 (slot 0 everywhere): the
        # cells where it differs are those the uniforms decided.
        zp, zd = tp.clone(), td.clone()
        ens.table_round_plain(mt, zp, zd, own, torch.zeros_like(u))
        decided = int((zp != kp).sum() + (zd != kd).sum())
        if not decided:
            raise AssertionError(f"{tag}'s table: no uniform decided")
        say(f"K10 == table_round_plain on {tag}'s table "
            f"({mt.out_cum.shape[1]} outcomes a row, {mt.out_cum.dtype}) "
            f"at B={B}, L={L}, E={E}, shared and per-member shifts, bit "
            f"for bit ({changed} cells changed, {decided} decided by the "
            "uniforms)")
        del mt, tp, td, kp, kd, pp, pd, zp, zd

    # (b) Independent sites at full width (K11).
    (ind, _), sec, la, ms = lattice_path(
        "b", lambda: ens.run_ensemble(gen, (ptape, dtape), dm5,
                                      (LATTICE_ROUNDS, E),
                                      independent_sites=True, device=dev),
        ("K11",), totals)
    if la["K11"] != 1 or la["K10"] or la["K1"]:
        raise AssertionError(f"path b: launches {la} (one resident launch "
                             f"for {LATTICE_ROUNDS} rounds)")
    check_run("b", ind, 5)
    record("b", la, seconds=sec, device_ms=ms)
    lattice_say("b", f"run_ensemble(independent_sites=True) on ex5's machine "
                f"at B={B}, L={L}, E={E}", sec, LATTICE_ROUNDS, la,
                f"; {ms / LATTICE_ROUNDS * 1e3:.2f} us a round on the card")
    own = torch.randint(0, L, (1, B), generator=gen, device=dev,
                        dtype=torch.int32)
    kp, kd = ind[0].to(torch.int8), ind[1].to(torch.int8)
    rp, rd = ens.independent_rounds_rolled_plain(dm5, kp.clone(), kd.clone(),
                                                 own, E)
    ens.run_lattice_rounds(dm5, kp, kd, own, E)
    torch.cuda.synchronize()
    if not diff("K11", ((kp, rp), (kd, rd))):
        raise AssertionError("K11 != the JAX package's rolled loop")
    say("K11 at per-member shifts == the reference's delta-rolled loop "
        "(independent_rounds_rolled_plain), bit for bit")
    del ind, rp, rd

    # (c) A wide stride: ex4 at E=32, stride 128 (K11, shared shift).
    dm4 = ens.compile_decision_machine(EX4)
    wp, wd = active_tapes(gen, EX4, 9, B, L, dev)
    (wide, _), sec, la, ms = lattice_path(
        "c", lambda: ens.run_ensemble(gen, (wp, wd), dm4,
                                      (LATTICE_ROUNDS, WIDE_E), device=dev),
        ("K11",), totals)
    chunk = max(1, ens._UNIFORM_CHUNK // (B * WIDE_E))
    if la["K11"] != -(-LATTICE_ROUNDS // chunk) or la["K1"]:
        raise AssertionError(f"path c: launches {la} (one resident launch "
                             f"a chunk of {chunk} rounds)")
    changed = int((wide[1] != wd).sum() + (wide[0] != wp).sum())
    if not changed:
        raise AssertionError("path c changed nothing")
    record("c", la, seconds=sec, device_ms=ms, cells_changed=changed)
    lattice_say("c", f"run_ensemble on ex4 at B={B}, L={L}, E={WIDE_E} "
                f"(stride {L // WIDE_E})", sec, LATTICE_ROUNDS, la,
                f"; {changed} cells changed")
    w8 = [t.to(torch.int8) for t in wide]
    for shift in (0, 5, 127, 4095):
        u = torch.rand((B, WIDE_E), generator=gen, device=dev)
        kp, kd = (t.clone() for t in w8)
        pp, pd = (t.clone() for t in w8)
        ens.lattice_round(dm4, kp, kd, shift, WIDE_E, u)
        ens.lattice_round_plain(dm4, pp, pd, shift, WIDE_E, u)
        torch.cuda.synchronize()
        if not diff("K11", ((kp, pp), (kd, pd))):
            raise AssertionError(f"K11 != plain on ex4 at shift {shift}")
    say(f"K11 == lattice_round_plain on ex4 at E={WIDE_E}, shifts 0, 5, "
        "127, 4095")
    del wide, w8, wp, wd

    # (d) The master-equation gates; (e) the examples.
    master_gates(dev, gen, totals, record, diff)
    fp_calls = example_runs(dev, gen, totals, record, diff)
    say(f"phase 9 launches by kernel over its paths: {totals}")
    # (g) K11's resident rounds and fused first passage, and K10's
    # resident rounds, at the full width and at rows too long to keep
    # resident, against the plain versions.
    resident_checks(dev, gen, dm5, tab, diff)
    table_resident_checks(dev, gen, tdt, tab, diff)

    # (f) Each kernel alone at the bench geometry, beside its bound, its
    # plain version and, for K13, torch.bincount.
    times = {}
    pt32, dt32 = tab
    s_shared = torch.randint(0, L, (1,), generator=gen, device=dev,
                             dtype=torch.int32)
    s_own = torch.randint(0, L, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    kp, kd = pt32.clone(), dt32.clone()
    one_ms = cuda_ms(lambda: ens.table_round(tdt, kp, kd, s_shared, u64), 50)
    one_bytes = table_bytes_k10(tdt, E)
    # The main path's form: a resident call of a chunk's rounds
    # (`ensemble._TABLE_CHUNK`) on fresh shifts and float64 uniforms, as
    # path (a) sends them; then path (a)'s round split into its float64
    # draw alone, that call's round and the rest.
    n_call = min(LATTICE_ROUNDS, ens._TABLE_CHUNK // (B * E))
    u_buf = torch.empty((n_call, B, E), dtype=torch.float64, device=dev)
    s_fresh = torch.randint(0, L, (n_call,), generator=gen, device=dev,
                            dtype=torch.int32)
    draw_ms = cuda_ms(lambda: torch.rand(
        (B, E), generator=gen, device=dev, dtype=torch.float64,
        out=u_buf[0]), 20)
    for j in range(n_call):
        torch.rand((B, E), generator=gen, device=dev, dtype=torch.float64,
                   out=u_buf[j])
    fresh_ms = cuda_ms(lambda: ens.run_lattice_rounds(
        tdt, kp, kd, s_fresh, E, u_buf), 5, warmup=1) / n_call
    call_bytes = table_call_bytes(tdt, B, L, E, n_call)
    tile10 = ens.k10_tile(B, L, E)
    times["K10"] = {
        "ms": fresh_ms,
        "plain_ms": cuda_ms(lambda: ens.table_round_plain(
            tdt, kp, kd, s_shared, u64), 3),
        "bound_ms": call_bytes / n_call / HBM_BYTES_PER_S * 1e3,
        "library_ms": None, "call_rounds": n_call, "call_bytes": call_bytes,
        "one_round_ms": one_ms, "one_round_bytes": one_bytes,
        "one_round_bound_ms": one_bytes / HBM_BYTES_PER_S * 1e3,
        "members_a_block": tile10[0], "threads": tile10[1],
        "smem_bytes": tile10[2], "blocks": -(-B // tile10[0])}
    say(f"K10 resident, a call of {n_call} rounds at B={B}, L={L}, E={E} "
        f"(ex5's table, float64 uniforms, shared shifts): "
        f"{fresh_ms * 1e3:.3f} us a round against "
        f"{times['K10']['bound_ms'] * 1e3:.3f} us a round for the call's "
        f"{call_bytes / 1e6:.1f} MB (rows in and out once, the shifts; one "
        f"outcome a row, so no uniform); a one-round call {one_ms * 1e3:.2f}"
        f" us against {one_bytes / HBM_BYTES_PER_S * 1e6:.2f}; {tile10[0]} "
        f"members a block, {tile10[1]} threads, {tile10[2]} bytes of shared "
        f"memory, {-(-B // tile10[0])} blocks")
    round_ms = paths["a"]["device_ms"] / LATTICE_ROUNDS
    times["K10"]["path_a_us"] = {
        "round": round_ms * 1e3, "draw": draw_ms * 1e3,
        "k10_fresh_draws": fresh_ms * 1e3,
        "rest": (round_ms - draw_ms - fresh_ms) * 1e3}
    say("path a's round split: " + ", ".join(
        f"{k} {v:.2f} us" for k, v in times["K10"]["path_a_us"].items()))
    del u_buf
    p8, d8 = pt32.to(torch.int8), dt32.to(torch.int8)
    for name, s in (("K11", s_shared), ("K11 per member", s_own)):
        times[name] = {
            "ms": cuda_ms(lambda: ens.lattice_round(dm5, p8, d8, s, E), 50),
            "plain_ms": cuda_ms(lambda: ens.lattice_round_plain(
                dm5, p8, d8, s, E), 3),
            "bound_ms": k1_bytes(dm5) / HBM_BYTES_PER_S * 1e3,
            "library_ms": None}
    # K11 resident: a call of LATTICE_ROUNDS rounds (path b's launch),
    # per round, beside the bound of the same work over the call: the
    # rows in and out once, a shift a round (a member), no uniforms (ex5).
    s_call = torch.randint(0, L, (LATTICE_ROUNDS, B), generator=gen,
                           device=dev, dtype=torch.int32)
    call_ms = cuda_ms(lambda: ens.run_lattice_rounds(dm5, p8, d8, s_call,
                                                     E), 5)
    call_bytes = 4 * B * L + s_call.numel() * 4
    tile = ens.k11_tile(B, L, E)
    times["K11 resident"] = {
        "us_a_round": call_ms / LATTICE_ROUNDS * 1e3,
        "bound_call_us_a_round": call_bytes / HBM_BYTES_PER_S * 1e6
        / LATTICE_ROUNDS, "call_bytes": call_bytes,
        "members_a_block": tile[0], "threads": tile[1],
        "smem_bytes": tile[2], "blocks": -(-B // tile[0])}
    say(f"K11 resident, {LATTICE_ROUNDS} rounds a launch at B={B}, L={L}, "
        f"E={E}, per-member shifts: {call_ms * 1e3 / LATTICE_ROUNDS:.3f} us "
        f"a round against {times['K11 resident']['bound_call_us_a_round']:.3f}"
        f" us a round for the call's {call_bytes / 1e6:.1f} MB (rows in and "
        f"out once, the shifts); {tile[0]} members a block, {tile[1]} "
        f"threads, {tile[2]} bytes of shared memory, "
        f"{-(-B // tile[0])} blocks")
    pat = torch.tensor([1, 1, 1], dtype=torch.int32, device=dev)
    k12_pairs = []
    for tape in (d8, dt32):
        want = ens.pattern_scan_plain(tape, pat, 0)
        want_prog = ens.pattern_scan_plain(tape, pat, 1)
        t0 = torch.where(torch.rand(B, generator=gen, device=dev) < 0.5,
                         torch.inf, 1.5).to(torch.float64)
        now = torch.tensor([2.5], dtype=torch.float64, device=dev)
        want_t = ens.pattern_scan_plain(tape, pat, 2, t_hit=t0.clone(),
                                        t_now=now)
        for _ in range(2):
            k12_pairs += [
                (ens.pattern_scan(tape, pat, 0), want),
                (ens.pattern_scan(tape, pat, 1), want_prog),
                (ens.pattern_scan(tape, pat, 2, t_hit=t0.clone(),
                                  t_now=now).nan_to_num(posinf=-1.0),
                 want_t.nan_to_num(posinf=-1.0))]
    torch.cuda.synchronize()
    if not diff("K12", k12_pairs):
        raise AssertionError("K12 != plain")
    want = ens.pattern_scan_plain(d8, pat, 0)
    times["K12"] = {
        "ms": cuda_ms(lambda: ens.pattern_scan(d8, pat, 0), 50),
        "plain_ms": cuda_ms(lambda: ens.pattern_scan_plain(d8, pat, 0), 3),
        "bound_ms": (B * L + B) / HBM_BYTES_PER_S * 1e3,
        "library_ms": None, "present": int(want.sum()),
        "int32_ms": cuda_ms(lambda: ens.pattern_scan(dt32, pat, 0), 20),
        "int32_bound_ms": (4 * B * L + B) / HBM_BYTES_PER_S * 1e3,
        "members_a_block": ens.k12_members(L, 1, 3),
        "int32_members_a_block": ens.k12_members(L, 4, 3)}
    cl_k13 = 5
    wts = torch.rand(B, generator=gen, device=dev, dtype=torch.float64)
    wn = wts / wts.sum()
    got = [ens.weighted_window_counts(dt32, wts, 5, cl_k13, device=dev)
           for _ in range(2)]
    want = ens.weighted_window_counts_plain(dt32, wn, 5, cl_k13)
    bins, bw = weighted_yardstick(dt32, wn, 5, cl_k13)
    lib = torch.bincount(bins, weights=bw, minlength=5**cl_k13) / L
    torch.cuda.synchronize()
    if not (diff("K13", [(g_, want) for g_ in got])
            and torch.equal(got[0], got[1])):
        raise AssertionError("K13 != plain")
    lib_err = float(((lib - want).abs() / want.abs().clamp(min=1e-300))
                    .max())
    if not lib_err < 1e-9:
        raise AssertionError(f"K13 against torch.bincount: rel {lib_err}")
    times["K13"] = {
        "ms": cuda_ms(lambda: ens.weighted_window_counts(
            dt32, wts, 5, cl_k13, device=dev), 20),
        "plain_ms": cuda_ms(lambda: ens.weighted_window_counts_plain(
            dt32, wn, 5, cl_k13), 3),
        "bound_ms": (B * L * 4 + B * 8 + 5**cl_k13 * 8) / HBM_BYTES_PER_S
        * 1e3,
        "library_ms": cuda_ms(lambda: torch.bincount(
            bins, weights=bw, minlength=5**cl_k13), 20),
        "bins": 5**cl_k13, "bincount_rel": lib_err}
    for name, t in times.items():
        if "ms" not in t:
            continue
        say(f"{name} alone at B={B}, L={L}: {t['ms'] * 1e3:.2f} us against a "
            f"bound of {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_ms'] / t['ms']:.3f} of it); plain "
            f"{t['plain_ms']:.3f} ms; library "
            + ("none" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.2f} us (torch.bincount)"))
    say("K12 == plain (contains, progress, first passage; int8 and int32) "
        "and K13 == plain, twice each, bit for bit")

    shapes = {"K10": f"ex5 table, B={B}, L={L}, E={E}, float64 uniforms, "
                     f"µs a round of a resident call of "
                     f"{times['K10']['call_rounds']} rounds",
              "K11": f"ex5 machine, B={B}, L={L}, E={E}, shared shift",
              "K12": f"int8 [{B}, {L}], pattern (1, 1, 1)",
              "K13": f"int32 [{B}, {L}], cl_k {cl_k13} ({5**cl_k13} bins)"}
    for k, (name, src, replaces) in LATTICE_KERNELS.items():
        t = times[k]
        kernels[k] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": totals[k],
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "shape": shapes[k]}
    kernels["K11"]["per_member"] = times["K11 per member"]
    kernels["K11"]["resident"] = times["K11 resident"]
    kernels["K12"].update({k: times["K12"][k] for k in (
        "int32_ms", "int32_bound_ms", "members_a_block",
        "int32_members_a_block")})
    fp_tile = ens.k11_tile(EX2FP["B"], EX2FP["L"], EX2FP["E"],
                           len(EX2FP["pattern"]))
    kernels["K11"]["first_passage"] = {
        "launches_a_c_call": max(k / c for k, c in fp_calls),
        "members_a_block": fp_tile[0], "threads": fp_tile[1],
        "smem_bytes": fp_tile[2]}
    kernels["K10"]["path_a_us"] = times["K10"]["path_a_us"]
    kernels["K10"]["resident"] = {k: v for k, v in times["K10"].items()
                                  if k not in ("path_a_us", "ms",
                                               "plain_ms", "bound_ms",
                                               "library_ms")}
    kernels["K10"]["paths"] = paths


# --- Phase 10: the bit-sliced rounds (K14, K15) ------------------------------

BITS_TAGS = [MAIN_TAG, EX4, EX2]  # their K14 units built in phase 2
BITS_ROUNDS = NUM_STEPS
C5_B, C5_L, C5_E, C5_ROUNDS = 10**7, 32, 2, 500  # bench.py:229-263
BITS_WRAPPERS = {"K14": [tbs.bitslice_round],
                 "K15": [tbs.pack_bitwords, tbs.unpack_bitwords],
                 "K1": [ens.plane_round]}
BITS_PLAIN = [tbs.apply_round_bitsliced, tbs.pack_bitwords_plain,
              tbs.unpack_bitwords_plain, ens.plane_round_plain]
BITS_KERNELS = {
    "K14": ("K14 bitslice_round", SRC + "bitslice_round.cuh",
            "the JAX package's engine/bitslice.py:882 apply_round_bitsliced "
            "with :698 _eval_circuit (XLA)"),
    "K15": ("K15 bitplanes", SRC + "bitplanes.cu",
            "the JAX package's engine/bitslice.py:754 tapes_to_bitplanes, "
            ":805 bitplanes_to_tapes, :841 stacked_planes_to_bitwords, "
            ":864 bitwords_to_stacked_planes (XLA)"),
}


def bits_path(label, fn):
    """Runs a bit-sliced main path with every count set to 0 just before
    and read just after; raises if any plain version ran. Returns (fn's
    result, seconds, launches, device ms by CUDA events)."""
    for fns in BITS_WRAPPERS.values():
        for f in fns:
            f.launches = 0
    for f in BITS_PLAIN:
        f.calls = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: sum(f.launches for f in fns)
                for k, fns in BITS_WRAPPERS.items()}
    plain = sum(f.calls for f in BITS_PLAIN)
    if plain:
        raise AssertionError(f"path {label}: plain calls {plain}")
    return result, seconds, launches, start.elapsed_time(end)


def bits_round_bytes(dm, circ, cols):
    """Least bytes a K14 round moves: every window word read and written
    once, the random words read once, 4 B each, over ``cols`` word
    columns."""
    return (2 * dm.n_cells * circ[2] + circ[3]) * 4 * cols


def bits_pack_bytes(batch, length, elem, nb):
    """Least bytes K15 moves either way: each symbol (``elem`` B) once and
    each word once (nb bits a symbol)."""
    return batch * length * elem + batch * length * nb // 8


def mix_tapes(gen, batch, length, dev):
    """bench.py:393-452's ex4 tape mix: program P, X, O at 0.45, 0.45,
    0.10; data A, B, C, D, I, O at 0.1 each but I and O at 0.3."""
    out = []
    for sym, p in (([6, 7, 5], [0.45, 0.45, 0.10]),
                   ([0, 1, 2, 3, 4, 5], [0.1, 0.1, 0.1, 0.1, 0.3, 0.3])):
        cdf = torch.tensor(np.cumsum(p)[:-1], dtype=torch.float32, device=dev)
        u = torch.rand((batch, length), generator=gen, device=dev)
        idx = torch.bucketize(u, cdf, right=True)
        out.append(torch.tensor(sym, dtype=torch.int32, device=dev)[idx])
    return out


def time_k14(dm, circ, words, gen, dev, transpose, label):
    """K14 alone (one launch a round, every phase in turn) against its
    plain version at ``words``' geometry, beside its bound; both on the
    same random words for a sampling circuit."""
    kp, kd = (w.clone() for w in words)
    axis = tbs.site_axis_of(kp, transpose)
    E_, W, _ = tbs._word_dims(kp, axis)
    stride = kp.shape[0]
    cycle = torch.arange(stride, dtype=torch.int32, device=dev)
    rw = (tbs.draw_rand_words(gen, (circ[3],) + tuple(kp.shape[2:]), dev)
          if circ[3] else None)
    it = iter(range(10**9))
    ms = cuda_ms(lambda: tbs.bitslice_round(
        dm, circ, kp, kd, cycle, next(it) % stride, rw, site_axis=axis), 200)
    plain_ms = cuda_ms(lambda: tbs.apply_round_bitsliced(
        dm, circ, kp, kd, int(next(it) % stride), site_axis=axis,
        rand_words=rw), 2, warmup=1)
    bound = bits_round_bytes(dm, circ, E_ * W) / HBM_BYTES_PER_S * 1e3
    say(f"K14 {label}: {ms * 1e3:.2f} us a round against a bound of "
        f"{bound * 1e3:.2f} us ({bits_round_bytes(dm, circ, E_ * W) / 1e6:.1f}"
        f" MB, {bound / ms:.3f} of it); plain {plain_ms:.3f} ms; "
        f"{len(circ[0])} ops, {E_ * W} word columns")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "library_ms": None, "ops": len(circ[0]), "columns": E_ * W}


def time_k15(tape, stride, nb, transpose, label):
    """K15's pack and unpack of ``tape`` ([B, L] int32) alone, against
    their plain versions and bounds."""
    B_, L_ = tape.shape
    view = tape.view(B_, L_ // stride, stride)
    words = tbs.pack_bitwords(view, nb, transpose=transpose)
    out = torch.empty_like(tape)
    target = out.view(B_, L_ // stride, stride)
    bound = bits_pack_bytes(B_, L_, 4, nb) / HBM_BYTES_PER_S * 1e3
    t = {"ms": cuda_ms(lambda: tbs.pack_bitwords(view, nb,
                                                 transpose=transpose), 20),
         "plain_ms": cuda_ms(lambda: tbs.pack_bitwords_plain(
             view, nb, transpose=transpose), 2, warmup=1),
         "bound_ms": bound, "library_ms": None,
         "unpack": {
             "ms": cuda_ms(lambda: tbs.unpack_bitwords(
                 words, target, transpose=transpose), 20),
             "plain_ms": cuda_ms(lambda: tbs.unpack_bitwords_plain(
                 words, target, transpose=transpose), 2, warmup=1),
             "bound_ms": bound}}
    say(f"K15 {label}: pack {t['ms'] * 1e3:.2f} us, unpack "
        f"{t['unpack']['ms'] * 1e3:.2f} us against a bound of "
        f"{bound * 1e3:.2f} us each ({bits_pack_bytes(B_, L_, 4, nb) / 1e6:.1f}"
        f" MB; {bound / t['ms']:.3f}, {bound / t['unpack']['ms']:.3f} of "
        f"it); plain {t['plain_ms']:.3f}, {t['unpack']['plain_ms']:.3f} ms")
    return t


def k15_against_plain(tape, stride, nb, transpose, diff, label):
    """K15 both ways against its plain version, bit for bit, on the
    [B, L] tape and on the FSM planes [stride, B, E] it makes."""
    B_, L_ = tape.shape
    planes = ens._tape_to_planes(tape.to(torch.int8), stride)
    for name, base, view in (
            ("tape", tape, lambda t: t.view(B_, L_ // stride, stride)),
            ("fsm planes", planes, lambda t: t.permute(1, 2, 0))):
        words = tbs.pack_bitwords(view(base), nb, transpose=transpose)
        plain = tbs.pack_bitwords_plain(view(base), nb, transpose=transpose)
        out = torch.full_like(base, -1)
        tbs.unpack_bitwords(words, view(out), transpose=transpose)
        back = torch.full_like(base, -1)
        tbs.unpack_bitwords_plain(words, view(back), transpose=transpose)
        torch.cuda.synchronize()
        if not (diff("K15", [(words, plain), (out, back)])
                and torch.equal(out, base)):
            raise AssertionError(f"K15 != plain on {label}, {name}")
        del words, plain, out, back
    say(f"K15 on {label}: pack and unpack == plain bit for bit on the "
        "[B, L] tape and on the FSM planes, and unpack restores both")


def bits_phase(dev, kernels, main_ref):
    """Phase 10 (module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(1010)
    max_err = {"K14": 0, "K15": 0}
    times, paths = {}, {}

    def diff(name, pairs):
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        max_err[name] = max(max_err[name], err)
        return err == 0.0

    # (a) ex5 at the bench geometry, the default route: K14 and K15.
    dm5 = ens.compile_decision_machine(MAIN_TAG)
    circ5 = tbs.machine_circuit(dm5)
    ptape, dtape = main_ref["start"]
    run_gen = torch.Generator(device=dev)

    def run_a():
        run_gen.set_state(main_ref["gen_state"])
        return ens.run_ensemble(run_gen, (ptape, dtape), dm5,
                                (BITS_ROUNDS, E), device=dev)

    us = {}
    for call in ("cold", "warm"):
        ((pa, da), _), sec, la, ms = bits_path("a", run_a)
        if (la["K14"] != BITS_ROUNDS or la["K15"] != 4 or la["K1"]):
            raise AssertionError(f"path a ({call}): launches {la}")
        k1_p, k1_d = main_ref["tapes"]
        if not (torch.equal(pa, k1_p) and torch.equal(da, k1_d)):
            raise AssertionError(f"path a ({call}): tapes != K1's")
        us[call] = ms * 1e3 / BITS_ROUNDS
        say(f"path a, {call}: run_ensemble (default: K14) on {MAIN_TAG} at "
            f"B={B}, L={L}, E={E}, {BITS_ROUNDS} rounds: {us[call]:.2f} us "
            f"a round, {B * E / (us[call] * 1e-6):.4e} transitions/s "
            f"(K1's run {main_ref['us_round'][call]:.2f}); launches {la}; "
            "tapes == K1's bit for bit")
    paths["a"] = {"launches": la, "us_round": us,
                  "k1_us_round": main_ref["us_round"]}
    la_main = la
    del pa, da
    words = [tbs.tapes_to_bitplanes(t, STRIDE, circ5[2], transpose=True)
             for t in main_ref["tapes"]]
    times["K14"] = time_k14(dm5, circ5, words, gen, dev, True,
                            f"ex5, B={B}, E={E}")
    del words
    times["K15"] = time_k15(main_ref["tapes"][0], STRIDE, circ5[2], True,
                            f"int32 [{B}, {L}], nb {circ5[2]}")
    k15_against_plain(main_ref["tapes"][1], STRIDE, circ5[2], True, diff,
                      f"ex5's data tape [{B}, {L}]")

    # (b) ex4, bench.py:393-452's tape mix, the sampling circuit.
    dm4 = ens.compile_decision_machine(EX4)
    circ4 = tbs.machine_circuit(dm4)
    p4, d4 = mix_tapes(gen, B, L, dev)
    kp, kd = (tbs.tapes_to_bitplanes(t, STRIDE, circ4[2], transpose=True)
              for t in (p4, d4))
    pp, pd = kp.clone(), kd.clone()
    shifts = torch.randint(0, STRIDE, (8,), generator=gen, device=dev,
                           dtype=torch.int32)
    for k in range(8):
        rw = tbs.draw_rand_words(gen, (circ4[3],) + tuple(kp.shape[2:]), dev)
        tbs.bitslice_round(dm4, circ4, kp, kd, shifts, k, rw, site_axis=-2)
        tbs.apply_round_bitsliced(dm4, circ4, pp, pd, shifts[k],
                                  site_axis=-2, rand_words=rw)
        torch.cuda.synchronize()
        if not diff("K14", [(kp, pp), (kd, pd)]):
            raise AssertionError(f"path b: K14 != plain at round {k}")
    changed = int((tbs.bitplanes_to_tapes(kp, transpose=True) != p4).sum())
    if changed == 0:
        raise AssertionError("path b: 8 rounds changed no program cell")
    say(f"path b: K14 == apply_round_bitsliced bit for bit over 8 rounds "
        f"of ex4's sampling circuit ({circ4[3]} random words a round; "
        f"{changed} program cells changed)")
    del kp, kd, pp, pd
    words = [tbs.tapes_to_bitplanes(t, STRIDE, circ4[2], transpose=True)
             for t in (p4, d4)]
    times["K14 ex4"] = time_k14(dm4, circ4, words, gen, dev, True,
                                f"ex4, B={B}, E={E}")
    del words
    times["K15 ex4"] = time_k15(d4, STRIDE, circ4[2], True,
                                f"int32 [{B}, {L}], nb {circ4[2]}")
    state = gen.get_state()
    ((bp, bd), _), sec_b, lb, ms_b = bits_path(
        "b", lambda: ens.run_ensemble(gen, (p4, d4), dm4, (BITS_ROUNDS, E),
                                      device=dev))
    if lb["K14"] != BITS_ROUNDS or lb["K15"] != 4 or lb["K1"]:
        raise AssertionError(f"path b: launches {lb}")
    ((fp, fd), _), _, lf, ms_f = bits_path(
        "b (K1)", lambda: ens.run_ensemble(gen, (p4, d4), dm4,
                                           (BITS_ROUNDS, E), bitslice=False,
                                           device=dev))
    if lf["K1"] != BITS_ROUNDS or lf["K14"]:
        raise AssertionError(f"path b (K1): launches {lf}")
    n_eff = B * (L // E)
    worst = 0.0
    for a, b_ in ((fp, bp), (fd, bd)):
        ca = ens.window_counts(a, dm4.size_a, 2, device=dev).cpu().numpy()
        cb = ens.window_counts(b_, dm4.size_a, 2, device=dev).cpu().numpy()
        pbar = 0.5 * (ca + cb)
        gate = 7 * np.sqrt(2.0 * pbar * (1 - pbar) / n_eff) + 3e-3
        if not (np.abs(ca - cb) < gate).all():
            raise AssertionError(f"path b: window law, max dev "
                                 f"{np.abs(ca - cb).max()}")
        worst = max(worst, float((np.abs(ca - cb) / gate).max()))
    moved = int((bd != d4).sum())
    if moved == 0:
        raise AssertionError("path b: the data tape never changed")
    # The round's random words alone, as the path draws them.
    buf = torch.empty((circ4[3], E, B // 32), dtype=torch.int32, device=dev)
    draw_us = cuda_ms(lambda: tbs.draw_rand_words(gen, tuple(buf.shape),
                                                  dev, out=buf), 50) * 1e3
    del buf
    paths["b"] = {"launches": lb, "us_round": ms_b * 1e3 / BITS_ROUNDS,
                  "k1_us_round": ms_f * 1e3 / BITS_ROUNDS,
                  "draw_us": draw_us, "law_worst_fraction_of_gate": worst}
    say(f"path b: ex4 (bench.py:393-452's mix), {BITS_ROUNDS} rounds: "
        f"default (K14) {paths['b']['us_round']:.2f} us a round, "
        f"{B * E / (paths['b']['us_round'] * 1e-6):.4e} transitions/s, "
        f"launches {lb}, of it the {circ4[3]} random words' draw "
        f"{draw_us:.2f} us; bitslice=False (K1) "
        f"{paths['b']['k1_us_round']:.2f} us; window counts at cl_k 2 "
        f"within 7 sigma + 3e-3 (worst {worst:.3f} of the gate)")
    del bp, bd, fp, fd, p4, d4
    gen.set_state(state)

    # (c) config5: ex5 at B=10^7, L=32, E=2, the 3-D word layout.
    c5_stride = C5_L // C5_E
    cp = torch.randint(0, 3, (C5_B, C5_L), generator=gen, device=dev,
                       dtype=torch.int32)
    cd = torch.zeros_like(cp)
    wshape = tbs.transposed_word_shape(C5_E, C5_B // 32)
    k15_against_plain(cp, c5_stride, circ5[2], True, diff,
                      f"config5's program tape [{C5_B}, {C5_L}]")
    c5_state = gen.get_state()
    ((c5p, c5d), _), sec_c, lc, ms_c = bits_path(
        "c", lambda: ens.run_ensemble(gen, (cp, cd), dm5, (C5_ROUNDS, C5_E),
                                      device=dev))
    if lc["K14"] != C5_ROUNDS or lc["K15"] != 4 or lc["K1"]:
        raise AssertionError(f"path c: launches {lc}")
    gen.set_state(c5_state)
    ((k1p, k1d), _), _, lk, ms_k = bits_path(
        "c (K1)", lambda: ens.run_ensemble(gen, (cp, cd), dm5,
                                           (C5_ROUNDS, C5_E), bitslice=False,
                                           device=dev))
    if not (torch.equal(c5p, k1p) and torch.equal(c5d, k1d)):
        raise AssertionError("path c: K14's tapes != K1's")
    if int((c5d != cd).sum()) == 0:
        raise AssertionError("path c: the data tape never changed")
    del k1p, k1d
    # Two keep_planes calls of 250 rounds against one 500-round call over
    # the same shifts (the two calls' draws, replayed).
    gen.set_state(c5_state)
    half = C5_ROUNDS // 2
    st, _ = ens.run_ensemble(gen, (cp, cd), dm5, (half, C5_E),
                             keep_planes=True, device=dev)
    if st.kind != "bits" or tuple(st.pbp.shape[2:]) != wshape:
        raise AssertionError(f"path c: state {st.kind} {tuple(st.pbp.shape)}")
    st, _ = ens.run_ensemble(gen, st, dm5, (half, C5_E), keep_planes=True,
                             device=dev)
    two = st.tapes()
    gen.set_state(c5_state)
    replay = torch.cat([torch.randint(0, c5_stride, (half,), generator=gen,
                                      device=dev, dtype=torch.int32)
                        for _ in range(2)])
    one = [tbs.tapes_to_bitplanes(t, c5_stride, circ5[2], transpose=True)
           for t in (cp, cd)]
    tbs.run_bitsliced_rounds(dm5, circ5, one[0], one[1], replay,
                             site_axis=-len(wshape))
    one = [tbs.bitplanes_to_tapes(w, transpose=True) for w in one]
    if not (torch.equal(two[0], one[0]) and torch.equal(two[1], one[1])):
        raise AssertionError("path c: two keep_planes calls != one call")
    del st, two, one
    paths["c"] = {"launches": lc, "us_round": ms_c * 1e3 / C5_ROUNDS,
                  "k1_us_round": ms_k * 1e3 / C5_ROUNDS, "seconds": sec_c}
    say(f"path c: config5 (ex5, B={C5_B}, L={C5_L}, E={C5_E}, words "
        f"{wshape}), {C5_ROUNDS} rounds: default (K14) "
        f"{paths['c']['us_round']:.2f} us a round (conversions included), "
        f"{C5_B * C5_E / (paths['c']['us_round'] * 1e-6):.4e} "
        f"transitions/s, launches {lc}; K1 {paths['c']['k1_us_round']:.2f}"
        " us a round; tapes == K1's bit for bit; two keep_planes calls of "
        f"{half} == one call of {C5_ROUNDS} over the same shifts")
    words = [tbs.tapes_to_bitplanes(t, c5_stride, circ5[2], transpose=True)
             for t in (c5p, c5d)]
    times["K14 config5"] = time_k14(dm5, circ5, words, gen, dev, True,
                                    f"config5, words {wshape}")
    del words
    times["K15 config5"] = time_k15(c5p, c5_stride, circ5[2], True,
                                    f"int32 [{C5_B}, {C5_L}], nb 3")
    del cp, cd, c5p, c5d
    torch.cuda.empty_cache()

    # (d) tests/test_master.py:75 through the default route: ex2's
    # sampling circuit, the port's master equation as the oracle.
    size_a, cl_k, Lm, rounds = 2, 3, 12, 18
    spd = np.asarray(ferromagnet_p0(cl_k, p_pair=0.1)).reshape((2,) * cl_k)
    p0 = tmaster.ring_trace_measure(spd, size_a, cl_k, Lm)
    Q = tmaster.build_ring_generator(EX2, Lm)
    t_end = rounds * -math.log1p(-1 / Lm)
    want = tmaster.state_window_marginals(
        tmaster.solve_master(Q, p0, [0.0, t_end])[-1], Lm, size_a, cl_k)
    dm2 = ens.compile_decision_machine(EX2)
    ones = torch.full((512,), 1 / 512, dtype=torch.float64, device=dev)

    def dynamics():
        reps = []
        for _ in range(16):
            d = ens.sample_tapes_from_spd(gen, spd, size_a, cl_k, 512, Lm,
                                          ring=True, device=dev)
            (_, d), _ = ens.run_ensemble(
                gen, (torch.zeros_like(d), d), dm2, (rounds, 1), device=dev)
            reps.append(ens.weighted_window_counts(d, ones, size_a, cl_k,
                                                   device=dev).cpu().numpy())
        return reps

    reps, sec_d, ld, _ = bits_path("d:75", dynamics)
    if ld["K14"] != 16 * rounds or ld["K15"] != 64 or ld["K1"]:
        raise AssertionError(f"path d: launches {ld}")
    z = z_of(reps, want)
    if not z < Z_GATE:
        raise AssertionError(f"path d: test_master.py:75 gate, z {z}")
    paths["d:75"] = {"launches": ld, "seconds": sec_d, "z": z}
    say(f"path d: tests/test_master.py:75 through the default route (ex2's "
        f"sampling circuit, K14): z {z:.2f} < {Z_GATE}; {sec_d:.3f} s; "
        f"launches {ld}")

    shapes = {"K14": f"ex5 circuit ({len(circ5[0])} ops), words [{STRIDE}, "
                     f"{circ5[2]}, {E}, {B // 32}], one round",
              "K15": f"pack of an int32 [{B}, {L}] tape, nb {circ5[2]}, "
                     "transposed words"}
    for k, (name, src, replaces) in BITS_KERNELS.items():
        t = times[k]
        kernels[k] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": la_main[k],
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "shape": shapes[k]}
    kernels["K14"]["ex4"] = times["K14 ex4"]
    kernels["K14"]["config5"] = times["K14 config5"]
    kernels["K14"]["paths"] = paths
    kernels["K15"]["unpack"] = times["K15"]["unpack"]
    kernels["K15"]["ex4"] = times["K15 ex4"]
    kernels["K15"]["config5"] = times["K15 config5"]


# --- Phase 11: the BFF interpreter (K16-K18) ---------------------------------

BFF_TAG, BFF_SELF = "ex6-mini-bff", "ex6-mini-bff-self"
BFF_MIDI = "ex6-mini-bff-midi"
BFF_UNIT_TAGS = [BFF_TAG, BFF_SELF, BFF_MIDI]  # their K17 units built in phase 2
BFF_E, BFF_ROUNDS = 64, 200  # bench.py:464-469: stride 64 > 2*span = 62
STRIDE_BFF = L // BFF_E
INT32_OPS_PER_S = 16.7e12  # 3 integer pipes of 132 SMs at 1.98 GHz (K14's)
BFF_WRAPPERS = {"K16": [tbff.bff_round], "K17": [tbb.bff_bitslice_round],
                "K18": [tbff.bff_mutate],
                "K15": [tbs.pack_bitwords, tbs.unpack_bitwords]}
BFF_PLAIN = [tbff.bff_round_plain, tbff.bff_mutate_plain,
             tbb.apply_bff_round_bitsliced, tbs.pack_bitwords_plain,
             tbs.unpack_bitwords_plain]
BFF_KERNELS = {
    "K16": ("K16 bff_round", SRC + "bff_round.cu",
            "the JAX package's engine/bff.py:461-550, the scan body of "
            "_run_ensemble_bff: :162 bff_fire under :288 apply_bff_round and "
            ":320 apply_bff_self_round (XLA)"),
    "K17": ("K17 bff_bitslice_round", SRC + "bitslice_round.cuh",
            "the JAX package's engine/bff_bitslice.py:318 "
            "apply_bff_round_bitsliced with engine/bitslice.py:698 "
            "_eval_circuit and the popcount of bff_bitslice.py:439-442 (XLA)"),
    "K18": ("K18 bff_mutate", SRC + "bff_round.cu",
            "the JAX package's engine/bff.py:506-518, the mutation step of "
            "_run_ensemble_bff's scan body (XLA)"),
}


def bff_path(label, fn):
    """Runs a BFF main path with every count set to 0 just before and
    read just after; raises if any plain version ran. Returns (fn's
    result, seconds, launches, device ms by CUDA events)."""
    for fns in BFF_WRAPPERS.values():
        for f in fns:
            f.launches = 0
    for f in BFF_PLAIN:
        f.calls = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: sum(f.launches for f in fns)
                for k, fns in BFF_WRAPPERS.items()}
    plain = sum(f.calls for f in BFF_PLAIN)
    if plain:
        raise AssertionError(f"path {label}: plain calls {plain}")
    return result, seconds, launches, start.elapsed_time(end)


def k16_bytes(m, sites, written):
    """Least bytes of a K16 round without lineage: each site's window read
    once (n_p + n_d cells, the fetches' and heads' range), each cell the
    round changed (``written``, counted on this run's tapes) written
    once."""
    return sites * ((0 if m.self_modifying else m.n_p) + m.n_d) + written


def k17_work(m, circ, cols):
    """(bytes, int32 operations) of a K17 round over ``cols`` word
    columns: every window word read and every data word written once, 4 B
    each; an operation a two-input gate. A LOP3 takes its inputs negated,
    so a NOT costs nothing, and fusing chains of gates into one LOP3
    would only lower the count: the operations' time is at most this."""
    nb = circ[2]
    n_in = ((0 if m.self_modifying else m.n_p) + m.n_d) * nb
    gates = sum(op[0] in ("and", "or", "xor") for op in circ[0])
    return cols * (n_in + m.n_d * nb) * 4, cols * gates


def k18_bytes(u, rate):
    """Least bytes of K18 without lineage on these draws: every uniform
    read (8 B); the drawn symbol read and the cell written only where hit
    (4 + 1 B)."""
    return u.numel() * 8 + int((u < rate).sum()) * 5


def pair_mi(tape, d, size_a):
    """Mutual information (nats) of (tape[i], tape[i + d]) over every
    member and site, on the tape's card (examples/ex6_bff_ensemble.py's
    `pair_mi`)."""
    a = tape.reshape(-1).long()
    b = torch.roll(tape, -d, dims=1).reshape(-1).long()
    joint = torch.bincount(a * size_a + b, minlength=size_a * size_a)
    joint = joint.double().reshape(size_a, size_a)
    joint /= joint.sum()
    outer = torch.outer(joint.sum(1), joint.sum(0))
    m = joint > 0
    return float((joint[m] * torch.log(joint[m] / outer[m])).sum())


def k17_against_plain(tag, pt, dt, E, shifts, diff, where):
    """K17 and its plain version on the words of [B, L] tapes ``pt`` and
    ``dt`` (the run's layout at E sites a round), one round at each of
    ``shifts``: words and opcode totals bit for bit."""
    mm = tbff.compile_bff(tag)
    cc = tbb.compile_bff_circuit(mm)
    B_, L_ = dt.shape
    transpose = E < B_ // 32
    words = [None if mm.self_modifying else tbs.tapes_to_bitplanes(
        pt, L_ // E, cc[2], transpose=transpose),
        tbs.tapes_to_bitplanes(dt, L_ // E, cc[2], transpose=transpose)]
    axis = tbs.site_axis_of(words[1], transpose)
    kd, pd = words[1].clone(), words[1].clone()
    for k in range(len(shifts)):
        got = tbb.bff_bitslice_round(mm, cc, words[0], kd, shifts, k,
                                     site_axis=axis)
        want = tbb.apply_bff_round_bitsliced(mm, cc, words[0], pd,
                                             int(shifts[k]),
                                             stride=pd.shape[0],
                                             site_axis=axis)
        if not diff("K17", [(got, want), (kd, pd)]):
            raise AssertionError(f"K17 != plain: {tag}, {where}, round {k}")
    say(f"(b/c) K17 {tag} ({len(cc[0])} ops) on {where} (B={B_}, L={L_}, "
        f"E={E}): {len(shifts)} rounds == plain bit for bit (words, "
        "totals)")


def scan_against_plain(label, m, tapes, prov, q, gen, dev, diff):
    """2 rounds of `run_bff_rounds` on the card (K16, and K18 at rate
    ``q``; one C call) at a shift a member and E=1, against
    `bff_round_plain` and `bff_mutate_plain` on the same shifts and draws:
    tapes, lineage and opcode totals bit for bit, some cell changed."""
    dt = tapes if m.self_modifying else tapes[1]
    Bn, Ln = dt.shape
    shifts = torch.randint(0, Ln, (2, Bn), generator=gen, device=dev,
                           dtype=torch.int32)
    draws = None
    if q:
        draws = (torch.rand((2, Bn, Ln), generator=gen, device=dev,
                            dtype=torch.float64),
                 torch.randint(0, m.size_a, (2, Bn, Ln), generator=gen,
                               device=dev, dtype=torch.int32))
    got, got_tot = tbff.run_bff_rounds(m, tapes, shifts, 1,
                                       mutation_draws=draws,
                                       mutation_rate=q, prov=prov,
                                       device=dev)
    p8 = None if m.self_modifying else tapes[0].to(torch.int8)
    d8 = dt.to(torch.int8)
    pv = None if prov is None else prov.clone()
    tots = []
    for k in range(2):
        tots.append(tbff.bff_round_plain(m, p8, d8, pv, shifts[k], 1))
        if q:
            tbff.bff_mutate_plain(d8, pv, draws[0][k], draws[1][k], q)
    want_tot = torch.stack(tots)
    if m.self_modifying:
        got_d, got_v = (got, None) if prov is None else got
    else:
        got_d, got_v = got[1], None
    pairs = [(got_tot, want_tot), (got_d, d8)] + (
        [] if pv is None else [(got_v, pv)])
    if not diff("K16", pairs) or (q and not diff("K18", pairs[1:])):
        raise AssertionError(f"gate {label}: run_bff_rounds != plain")
    if not bool((d8 != dt).any()):
        raise AssertionError(f"gate {label}: no cell changed")
    say(f"(c) {label}: 2 rounds of run_bff_rounds at the gate's geometry "
        f"({Bn} members, L={Ln}, E=1, a shift a member"
        f"{f', mutation {q}' if q else ''}"
        f"{', lineage' if pv is not None else ''}) == plain bit for bit; "
        f"{int((d8 != dt).sum())} cells changed")


def bff_law_gates(dev, gen, record, diff):
    """(c): twins of tests/test_bff.py's three master-equation gates, the
    replicas one batch with independent sites (K16, K18), each held to
    the plain versions at its geometry first, and
    examples/ex6_bff_ensemble.py's run (K17, K15), K17 held to its plain
    version at its geometry first, with the claims of
    tests/test_oracles.py:538-561 on the port's own run."""
    tm = tmaster
    L, cl_k, rounds, n_keys, B_k = 4, 2, 24, 8, 1024

    def gate(label, tag, Q, q, ptape):
        m = tbff.compile_bff(tag)
        A = m.size_a
        mut = np.full((A, A), q / A)
        mut[np.diag_indices(A)] += 1.0 - q
        p = np.full(A ** L, 1.0 / A ** L)
        for _ in range(rounds):
            p = p + (Q @ p) / L
            if q:
                t = p.reshape((A,) * L)
                for ax in range(L):
                    t = np.moveaxis(np.tensordot(mut, t, axes=(1, ax)), 0,
                                    ax)
                p = t.ravel()
        want = tm.state_window_marginals(p, L, A, cl_k)
        tape = torch.randint(0, A, (n_keys * B_k, L), generator=gen,
                             device=dev, dtype=torch.int32)
        tapes = tape if ptape is None else (ptape, tape)
        prov = (torch.arange(tape.numel(), dtype=torch.int32,
                             device=dev).reshape(tape.shape)
                if m.self_modifying else None)
        # The gate's program never writes ([9 1 2 2] under the lite
        # machine), so the two-tape check takes a random program a member.
        scan_against_plain(label, m, tapes if ptape is None else (
            torch.randint(0, A, ptape.shape, generator=gen, device=dev,
                          dtype=torch.int32), tape),
            prov, q, gen, dev, diff)

        def run():
            return tbff.run_ensemble_bff(gen, tapes, m, (rounds, 1),
                                         independent_sites=True,
                                         mutation_rate=q, device=dev)

        (out, _), sec, la, _ = bff_path(label, run)
        if la["K16"] != rounds or la["K18"] != (rounds if q else 0):
            raise AssertionError(f"gate {label}: launches {la}")
        out = out if ptape is None else out[1]
        w = torch.full((B_k,), 1.0 / B_k, dtype=torch.float64, device=dev)
        reps = [ens.weighted_window_counts(out[k * B_k:(k + 1) * B_k], w, A,
                                           cl_k, device=dev).cpu().numpy()
                for k in range(n_keys)]
        floor = np.sqrt(np.maximum(want, 1e-9) * np.clip(1.0 - want, 0, 1)
                        / (n_keys * B_k * L / cl_k))
        z = z_of(reps, want, floor)
        if not z < Z_GATE:
            raise AssertionError(f"gate {label}: z {z}")
        record[label] = {"z": z, "launches": la, "seconds": sec}
        say(f"(c) {label}: z {z:.2f} < {Z_GATE} ({n_keys} x {B_k} members, "
            f"L={L}, {rounds} rounds of E=1); launches {la}; {sec:.3f} s")

    # The reference test's program ring (seed 3, [9 1 2 2]) never
    # writes, so its law is the uniform start; seed 0's ([10 7 6 3])
    # moves the window marginals up to 0.076 off uniform.
    lite = "ex6-mini-bff-lite"
    for seed, label in ((3, "test_bff.py conditioned master"),
                        (0, "conditioned master, a writing program")):
        pr = np.random.default_rng(seed).integers(0, 12, L)
        ptape = torch.as_tensor(
            np.tile(pr.astype(np.int32), (n_keys * B_k, 1)), device=dev)
        gate(label, lite, tm.build_conditioned_ring_generator(lite, pr),
             0.0, ptape)
    Q = tm.build_ring_generator("ex6-mini-bff-self-lite", L)
    gate("test_bff.py ring master", "ex6-mini-bff-self-lite", Q, 0.0, None)
    gate("test_bff.py mutation kernel", "ex6-mini-bff-self-lite", Q, 0.05,
         None)

    # examples/ex6_bff_ensemble.py: B 4096, L 256, E 4, 640 rounds in 20
    # calls, MI profile d 1-24 of the data tapes.
    m = tbff.compile_bff(BFF_TAG)
    A = m.size_a
    Bx, Lx, Ex, snaps, per = 4096, 256, 4, 20, 32
    pt = torch.randint(0, A, (Bx, Lx), generator=gen, device=dev,
                       dtype=torch.int32)
    dt = torch.randint(0, A, (Bx, Lx), generator=gen, device=dev,
                       dtype=torch.int32)
    ds = np.arange(1, 25)
    mi0 = np.array([pair_mi(dt, int(d), A) for d in ds])
    k17_against_plain(BFF_TAG, pt, dt, Ex,
                      torch.randint(0, Lx, (2,), generator=gen, device=dev,
                                    dtype=torch.int32),
                      diff, "examples/ex6_bff_ensemble.py's tapes")

    def run():
        p_, d_ = pt, dt
        for _ in range(snaps):
            (p_, d_), _ = tbff.run_ensemble_bff(gen, (p_, d_), m, (per, Ex),
                                                device=dev)
        return d_

    d_end, sec, la, ms = bff_path("ex6_bff_ensemble", run)
    if la["K17"] != snaps * per or la["K16"] or la["K15"] != 3 * snaps:
        raise AssertionError(f"ex6_bff_ensemble: launches {la}")
    mi = np.array([pair_mi(d_end, int(d), A) for d in ds])
    marg = torch.bincount(d_end.reshape(-1).long(), minlength=A).double()
    dev_m = (marg / marg.sum() - 1.0 / A).cpu().numpy()
    copy = ((pt == m.dot) | (pt == m.comma)).double().mean(1)
    lo = copy <= copy.median()
    mi_lo = pair_mi(d_end[lo], 12, A)
    mi_hi = pair_mi(d_end[~lo], 12, A)
    shoulder = mi[ds >= 17].mean()
    claims = {
        "MI(12) / shoulder > 50": mi[11] / shoulder,
        "MI(24) / MI(19) > 5": mi[23] / mi[18],
        "MI(12) growth > 100": mi[11] / mi0[11],
        "'zero' enrichment > 0.03": float(dev_m[m.zero]),
        "MI_hi(12) / MI_lo(12) > 1.1": mi_hi / mi_lo,
    }
    ok = (claims["MI(12) / shoulder > 50"] > 50
          and claims["MI(24) / MI(19) > 5"] > 5
          and claims["MI(12) growth > 100"] > 100
          and int(dev_m.argmax()) == m.zero
          and claims["'zero' enrichment > 0.03"] > 0.03
          and claims["MI_hi(12) / MI_lo(12) > 1.1"] > 1.1)
    say(f"(c) examples/ex6_bff_ensemble.py on the port (B={Bx}, L={Lx}, "
        f"E={Ex}, {snaps * per} rounds, default route): "
        + ", ".join(f"{k}: {v:.4g}" for k, v in claims.items())
        + f"; most enriched symbol {int(dev_m.argmax())}; launches {la}; "
        f"{sec:.3f} s, {ms * 1e3 / (snaps * per):.2f} us a round")
    if not ok:
        raise AssertionError(f"ex6_bff_ensemble claims fail: {claims}")
    record["ex6_bff_ensemble"] = {"claims": claims, "launches": la,
                                  "seconds": sec}


def bff_phase(dev, kernels, unit_builds):
    """Phase 11 (module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(1111)
    max_err = {"K16": 0, "K17": 0, "K18": 0}
    m = tbff.compile_bff(BFF_TAG)
    circ = tbb.compile_bff_circuit(m)
    sites = B * BFF_E

    def diff(name, pairs):
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        max_err[name] = max(max_err[name], err)
        return err == 0.0

    # (a) Full width, the default route (K17 with K15) and the scan (K16)
    # at the same seed, so at the same shifts.
    ptape = torch.randint(0, m.size_a, (B, L), generator=gen, device=dev,
                          dtype=torch.int32)
    dtape = torch.randint(0, m.size_a, (B, L), generator=gen, device=dev,
                          dtype=torch.int32)
    paths, us = {}, {}

    def run(engine):
        return lambda: tbff.run_ensemble_bff(11, (ptape, dtape), m,
                                             (BFF_ROUNDS, BFF_E),
                                             engine=engine, device=dev)

    for call in ("cold", "warm"):
        ((pa, da), (ops_a, times_a)), sec, la, ms = bff_path(
            "a:default", run("auto"))
        if la["K17"] != BFF_ROUNDS or la["K15"] != 3 or la["K16"]:
            raise AssertionError(f"path a ({call}): launches {la}")
        us[call] = ms * 1e3 / BFF_ROUNDS
        say(f"path a, {call}: run_ensemble_bff (default: K17) on {BFF_TAG} "
            f"at B={B}, L={L}, E={BFF_E}, {BFF_ROUNDS} rounds: "
            f"{us[call]:.2f} us a round, "
            f"{sites / (us[call] * 1e-6):.4e} site events/s; launches {la}; "
            f"{sec:.3f} s")
    la_main = la
    ((ps, ds_), (ops_s, times_s)), sec_s, ls, ms_s = bff_path(
        "a:scan", run("scan"))
    if ls["K16"] != BFF_ROUNDS or ls["K17"] or ls["K15"]:
        raise AssertionError(f"path a (scan): launches {ls}")
    us_scan = ms_s * 1e3 / BFF_ROUNDS
    if not (torch.equal(pa, ps) and torch.equal(da, ds_)
            and torch.equal(ops_a, ops_s) and torch.equal(times_a, times_s)
            and torch.equal(pa, ptape)):
        raise AssertionError("path a: the default route != the scan")
    if int(ops_a.sum()) != BFF_ROUNDS * sites * m.fuel or ops_a.shape != (
            BFF_ROUNDS, m.size_a):
        raise AssertionError(f"path a: opcode totals {int(ops_a.sum())}")
    want_t = -math.log1p(-BFF_E / L) * BFF_ROUNDS
    if abs(float(times_a[-1]) - want_t) > 1e-12 * want_t:
        raise AssertionError("path a: times")
    changed = int((da != dtape).sum())
    say(f"path a, scan (K16): {us_scan:.2f} us a round; launches {ls}; "
        f"default == scan bit for bit (tapes and the {BFF_ROUNDS} x "
        f"{m.size_a} opcode totals, sum {int(ops_a.sum())} = rounds x B x E x "
        f"fuel); {changed} data cells changed")
    paths["a"] = {"launches": la_main, "us_round": us,
                  "scan_us_round": us_scan, "scan_launches": ls,
                  "site_events_per_s": sites / (us["warm"] * 1e-6)}
    del ps, ds_

    # (b) Each kernel against its plain version on the card, 2 rounds on
    # (a)'s full-width tapes and words.
    pt8 = pa.to(torch.int8)
    dt8 = da.to(torch.int8)
    ms_ = tbff.compile_bff(BFF_SELF)
    shifts = torch.randint(0, L, (2,), generator=gen, device=dev,
                           dtype=torch.int32)
    per_member = torch.randint(0, L, (2, B), generator=gen, device=dev,
                               dtype=torch.int32)
    prov0 = torch.arange(B * L, dtype=torch.int32,
                         device=dev).reshape(B, L)
    variants = [("two-tape", m, pt8, None, shifts, 0.0),
                ("self-modifying", ms_, None, None, shifts, 0.0),
                ("lineage", ms_, None, prov0, shifts, 0.0),
                ("per-member", m, pt8, None, per_member, 0.0),
                ("mutation 0.01", ms_, None, prov0, shifts, 0.01)]
    for name, mm, p_, v_, sh, rate in variants:
        kd, pd = dt8.clone(), dt8.clone()
        kv = None if v_ is None else v_.clone()
        pv = None if v_ is None else v_.clone()
        for k in range(2):
            got = tbff.bff_round(mm, p_, kd, sh[k], BFF_E, prov=kv)
            want = tbff.bff_round_plain(mm, p_, pd, pv, sh[k], BFF_E)
            pairs = [(got, want), (kd, pd)] + (
                [] if kv is None else [(kv, pv)])
            if not diff("K16", pairs):
                raise AssertionError(f"K16 != plain: {name}, round {k}")
            if rate:
                u = torch.rand(dt8.shape, generator=gen, device=dev,
                               dtype=torch.float64)
                vals = torch.randint(0, mm.size_a, dt8.shape, generator=gen,
                                     device=dev, dtype=torch.int32)
                tbff.bff_mutate(kd, kv, u, vals, rate)
                tbff.bff_mutate_plain(pd, pv, u, vals, rate)
                if not diff("K18", [(kd, pd), (kv, pv)]):
                    raise AssertionError(f"K18 != plain, round {k}")
        torch.cuda.synchronize()
        say(f"(b) K16 {name} ({mm.tag}, all {B} members of (a)'s tapes)"
            f"{' then K18' if rate else ''}: 2 rounds == plain bit for bit "
            f"(tapes{', lineage' if kv is not None else ''}, totals); "
            f"{int((kd != dt8).sum())} cells changed")
    del pt8, dt8, prov0
    transpose = BFF_E < B // 32
    for tag in BFF_UNIT_TAGS:
        k17_against_plain(tag, pa, da, BFF_E, shifts, diff,
                          "(a)'s full-width tapes")
    torch.cuda.empty_cache()

    # (c) The law gates.
    record = {}
    bff_law_gates(dev, gen, record, diff)
    paths["c"] = record

    # (d) Each kernel alone at (a)'s geometry, by CUDA events.
    times = {}
    cyc = torch.randint(0, L, (64,), generator=gen, device=dev,
                        dtype=torch.int32)
    p8, d8 = pa.to(torch.int8), da.to(torch.int8)
    before = d8.clone()
    tbff.bff_round(m, p8, d8, cyc[0], BFF_E)
    written = int((d8 != before).sum())
    del before
    it = iter(range(10**9))
    k16_ms = cuda_ms(lambda: tbff.bff_round(m, p8, d8, cyc[next(it) % 64],
                                            BFF_E), 50)
    k16_plain = cuda_ms(lambda: tbff.bff_round_plain(
        m, p8, d8, None, cyc[next(it) % 64], BFF_E), 2, warmup=1)
    b16 = k16_bytes(m, sites, written)
    times["K16"] = {"ms": k16_ms, "plain_ms": k16_plain,
                    "bound_ms": b16 / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "bytes": b16, "cells_written_a_round": written}
    words = [tbs.tapes_to_bitplanes(t, STRIDE_BFF, circ[2],
                                    transpose=transpose) for t in (pa, da)]
    axis = tbs.site_axis_of(words[1], transpose)
    E_, W, _ = tbs._word_dims(words[1], axis)
    k17_ms = cuda_ms(lambda: tbb.bff_bitslice_round(
        m, circ, words[0], words[1], cyc, next(it) % 64, site_axis=axis), 50)
    k17_plain = cuda_ms(lambda: tbb.apply_bff_round_bitsliced(
        m, circ, words[0], words[1], int(cyc[next(it) % 64]),
        stride=words[1].shape[0], site_axis=axis), 2, warmup=1)
    by, ops = k17_work(m, circ, E_ * W)
    b_bytes, b_ops = by / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    # b_ops is at least the operations' least time (k17_work): where it
    # lies below the bytes' time, the bytes bound the round exactly.
    times["K17"] = {"ms": k17_ms, "plain_ms": k17_plain,
                    "bound_ms": max(b_bytes, b_ops),
                    "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                    "library_ms": None, "bytes": by, "int32_ops": ops,
                    "bytes_ms": b_bytes, "ops_ms": b_ops,
                    "columns": E_ * W}
    del words
    u = torch.rand((B, L), generator=gen, device=dev, dtype=torch.float64)
    vals = torch.randint(0, m.size_a, (B, L), generator=gen, device=dev,
                         dtype=torch.int32)
    k18_ms = cuda_ms(lambda: tbff.bff_mutate(d8, None, u, vals, 0.01), 20)
    k18_plain = cuda_ms(lambda: tbff.bff_mutate_plain(d8, None, u, vals,
                                                      0.01), 3)
    b18 = k18_bytes(u, 0.01)
    times["K18"] = {"ms": k18_ms, "plain_ms": k18_plain,
                    "bound_ms": b18 / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None, "bytes": b18}
    del u, vals, p8, d8
    for k, t in times.items():
        say(f"{k} alone at B={B}, L={L}, E={BFF_E}: {t['ms'] * 1e3:.2f} us a "
            f"round against a bound of {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}; {t['bound_ms'] / t['ms']:.3f} of it); plain "
            f"{t['plain_ms']:.3f} ms")
    build = unit_builds.get(BFF_TAG, {})
    say(f"K17 {BFF_TAG} unit: nvcc {build.get('seconds', 0.0):.2f} s, "
        f"{build.get('registers')} registers, {build.get('spill')}")
    torch.cuda.empty_cache()

    shapes = {"K16": f"{BFF_TAG}, int8 [{B}, {L}] tapes, E={BFF_E} "
                     f"({sites} site events), shared shift",
              "K17": f"{BFF_TAG} circuit ({len(circ[0])} ops), words "
                     f"[{STRIDE_BFF}, {circ[2]}, {BFF_E}, {B // 32}]",
              "K18": f"int8 [{B}, {L}] tape, float64 draws, rate 0.01"}
    for k, (name, src, replaces) in BFF_KERNELS.items():
        t = times[k]
        kernels[k] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": {"K16": ls["K16"], "K17": la_main["K17"],
                         "K18": record["test_bff.py mutation kernel"][
                             "launches"]["K18"]}[k],
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": shapes[k], "detail": t}
    kernels["K17"]["paths"] = paths
    kernels["K17"]["build"] = build


# --- Phase 12: the weighted frontier (K19-K22, K11's tempered rounds) -------

FR_L, FR_ROUNDS, FR_E = 64, 512, 4  # bench.py:303-360 (bench_frontier)
FR_STRIDE = FR_L // FR_E
FR_K_A, FR_BLOCKS_A = 1_000_000, 6     # (a), bench.py:326-333
FR_K_B, FR_BLOCKS_B = 10_000_000, 3    # (b), config 5, bench.py:645-658
FR_K_C, FR_L_C, FR_STEPS_C = 1_000_000, 32, 50  # (c), bench.py:363-392
# Tempered rounds a C call at (a): the block's draws come in chunks of at
# most `ensemble._RESIDENT_CHUNK` uniforms (67 rounds at K=10^6, E=4).
FR_CALL_ROUNDS = ens._RESIDENT_CHUNK // (FR_K_A * FR_E)
# K22's split a step at (c) in the parent design (a thread a member ranks,
# a library sort, a thread a slot writes byte by byte), ms, by
# time_beam_aug.py on an H100 80GB HBM3 at 700 W: M = 1 (ex5's table),
# M = 2 (ex2's). Printed beside this run's split, never in the kernels
# line: this run does not measure it.
K22_PARENT_SPLIT = {False: {"rank": 0.09432, "max and shift": 0.01437},
                    True: {"rank": 0.03532, "sort": 0.33467,
                           "allocations and slices": 0.00034,
                           "write": 0.73019}}
FR_WRAPPERS = {"K19": tfr.content_hash, "K20": tfr.merge_resample,
               "K21": tfr.gather_pair, "K22": tfr.frontier_step,
               "K11t": tfr.tempered_round, "K11": ens.lattice_round,
               "K14": tbs.bitslice_round, "K15p": tbs.pack_bitwords,
               "K15u": tbs.unpack_bitwords, "K12": ens.pattern_scan}
FR_PLAIN = [tfr.content_hash_plain, tfr.merge_resample_plain,
            tfr.gather_pair_plain, tfr.frontier_rank_plain,
            tfr.frontier_write_plain, ens.lattice_round_plain,
            tbs.apply_round_bitsliced, tbs.pack_bitwords_plain,
            tbs.unpack_bitwords_plain]
FR_KERNELS = {
    "K19": ("K19 content_hash", SRC + "frontier.cu",
            "the JAX package's engine/ensemble.py:1618 _content_hash (XLA)"),
    "K20": ("K20 merge_resample", SRC + "frontier.cu",
            "the JAX package's engine/ensemble.py:1823 "
            "_merge_resample_sorted, :1778 _merge_resample_positions and "
            ":1645 _merge_stats after their sort (XLA)"),
    "K21": ("K21 gather_pair", SRC + "frontier.cu",
            "the JAX package's engine/ensemble.py:2251 "
            "_gather_planes_pair_packed with :2181 _gather_plane_columns "
            "and :2501 flag[parent] (XLA)"),
    "K22": ("K22 frontier_step", SRC + "frontier.cu",
            "the JAX package's engine/ensemble.py:1899 "
            "run_weighted_frontier's step (:2019-2070, :1991 _write_decode; "
            "XLA)"),
    "K11t": ("K11 tempered (increments)", SRC + "lattice_round.cuh",
             "the JAX package's engine/ensemble.py:2090 _blocked_rounds' "
             "FSM route: :1170 _apply_plane_round_fsm_stacked(want_logp) "
             "with :705 _machine_specs_planes_leveled's increments (XLA)"),
}


def frontier_path(label, fn):
    """Runs a frontier main path with every count set to 0 just before
    and read just after; raises if any plain version ran. Returns (fn's
    result, seconds, launches, device ms by CUDA events)."""
    for f in FR_WRAPPERS.values():
        f.launches = 0
    for f in FR_PLAIN:
        f.calls = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in FR_WRAPPERS.items()}
    plain = {f.__name__: f.calls for f in FR_PLAIN if f.calls}
    if plain:
        raise AssertionError(f"path {label}: plain calls {plain}")
    return result, seconds, launches, start.elapsed_time(end)


def launch_record(fn):
    """One call of ``fn`` by torch.profiler, after an untraced call and a
    traced warm-up: the CUDA runtime's launch calls as the host makes
    them (cudaLaunchKernel, cudaLaunchKernelExC, ...), and the names of
    the kernels and memsets the profiler saw run on the card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return ([e.name for e in events if e.name.startswith("cudaLaunch")],
            [e.name for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA])


def need_launches(label, launches, names):
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"path {label}: {missing} never launched "
                             f"({launches})")


def frontier_start(gen, K, L, hi, dev):
    """bench_frontier's start: program tapes uniform over [0, hi), data
    tapes zero, uniform log-weights."""
    pt = torch.randint(0, hi, (K, L), generator=gen, device=dev,
                       dtype=torch.int8)
    return (pt, torch.zeros((K, L), dtype=torch.int8, device=dev),
            torch.full((K,), -math.log(K), dtype=torch.float64, device=dev))


def frontier_checks(label, out, K, L, size_a, blocks):
    (pt, dt), lw, nu = out
    if pt.shape != (K, L) or pt.dtype != torch.int8 or nu.shape != (blocks,):
        raise AssertionError(f"{label}: shapes {tuple(pt.shape)}, "
                             f"{tuple(nu.shape)}")
    for t in (pt, dt):
        if int(t.min()) < 0 or int(t.max()) >= size_a:
            raise AssertionError(f"{label}: symbol out of range")
    if not (torch.isfinite(lw).any()
            and abs(float(torch.logsumexp(lw, 0))) < 1e-9):
        raise AssertionError(f"{label}: weights not normalised")
    if not (1 <= int(nu.min()) and int(nu.max()) <= K):
        raise AssertionError(f"{label}: n_unique {nu.tolist()}")


def merge_alone(lw, pt, dt, stride, gen, dev):
    """The blocked merge's parts alone by CUDA events: K19, the sort,
    K20 (w/m or equal weights by K, as `_blocked_merge`) and K21."""
    K = lw.shape[0]
    mode = 1 if K >= tfr._MERGE_STAGED_MIN_K else 0
    u = torch.rand((), generator=gen, dtype=torch.float64, device=dev)
    h = tfr.content_hash(pt, dt, stride=stride, bits=4)
    parent = tfr.merge_resample(h, lw, u, mode)[0]
    return {"K19": cuda_ms(lambda: tfr.content_hash(pt, dt, stride=stride,
                                                    bits=4), 10),
            "sort": cuda_ms(lambda: tfr.sort_hashes(h), 10),
            "K20": cuda_ms(lambda: tfr.merge_resample(h, lw, u, mode), 10),
            "K21": cuda_ms(lambda: tfr.gather_pair(pt, dt, parent), 10),
            "mode": mode}


def frontier_kernels_against_plain(label, pt, dt, lw, stride, gen, diff):
    """K19, K20 (its mode for this K, and the weight-only mode) and K21
    on (pt, dt, lw) against their plain versions on the card, bit for
    bit. Returns the hashes and parents."""
    K = lw.shape[0]
    mode = 1 if K >= tfr._MERGE_STAGED_MIN_K else 0
    flag = torch.rand(K, generator=gen, device=pt.device) < 0.3
    h = tfr.content_hash(pt, dt, stride=stride, bits=4)
    hf = tfr.content_hash(pt, dt, stride=stride, bits=4, flag=flag)
    if not (diff("K19", [(h, tfr.content_hash_plain(pt, dt, stride, 4))])
            and diff("K19", [(hf, tfr.content_hash_plain(pt, dt, stride, 4,
                                                         flag))])):
        raise AssertionError(f"K19 != plain at {label}")
    u = torch.rand((), generator=gen, dtype=torch.float64, device=pt.device)
    hs, perm = tfr.sort_hashes(h)
    for m in (mode, 2):
        got = tfr.merge_resample(h, lw, u, m)
        want = tfr.merge_resample_plain(hs, perm, lw, u, m, math.log(K))
        if not diff("K20", list(zip(got, want))):
            raise AssertionError(f"K20 (mode {m}) != plain at {label}")
    parent = tfr.merge_resample(hf, lw, u, 0)[0]
    got = tfr.gather_pair(pt, dt, parent, flag)
    if not diff("K21", list(zip(got, tfr.gather_pair_plain(pt, dt, parent,
                                                           flag)))):
        raise AssertionError(f"K21 != plain at {label}")
    torch.cuda.synchronize()
    n_unique = int(tfr.merge_resample(h, lw, u, mode)[2])
    say(f"{label}: K19 (4 bits, with and without a flag), K20 (mode "
        f"{mode} and the weight-only mode) and K21 (with the flag) == plain "
        f"bit for bit; {n_unique} distinct of {K}")
    del hs, perm, got


def tempered_launches(K, L, n):
    """K11's tempered launches for a call of n rounds: one where the
    resident form takes it, else one a round."""
    resident = (n >= ens.K11_RESIDENT_MIN_ROUNDS
                and ens.k11_tempered_tile(K, L) is not None)
    return 1 if resident else n


def tempered_against_plain(label, dm, pt, dt, lw, gen, diff):
    """Tempered rounds at tau 0.5 (K11's increment entry) in both forms,
    a resident call of 8 rounds and a call of 2 (a launch a round),
    against the plain tempered round on the card: tapes and lw bit for
    bit, and each call's launches."""
    K, L = pt.shape
    k = [pt.clone(), dt.clone(), lw.clone()]
    p = [pt.clone(), dt.clone(), lw.clone()]
    for n in (8, 2):
        shifts = torch.randint(0, L // FR_E, (n,), generator=gen,
                               device=pt.device, dtype=torch.int32)
        u = torch.rand((n, K, FR_E), generator=gen, device=pt.device)
        before = tfr.tempered_round.launches
        tfr.tempered_round(dm, k[0], k[1], shifts, FR_E, u, 0.5, k[2])
        got = tfr.tempered_round.launches - before
        if got != tempered_launches(K, L, n):
            raise AssertionError(f"{label}: {n} tempered rounds, {got} "
                                 f"launches")
        for j in range(n):
            ens.lattice_round_plain(dm, p[0], p[1], shifts[j], FR_E, u[j],
                                    tau=0.5, lw=p[2])
        if not diff("K11t", list(zip(k, p))):
            raise AssertionError(f"tempered round != plain: {label}, {n} "
                                 f"rounds")
        del u
    moved = int((k[2] != lw).sum())
    if not moved:
        raise AssertionError(f"{label}: no increment")
    say(f"{label}: tempered rounds (tau 0.5) == plain bit for bit, a "
        f"resident call of 8 rounds (1 launch) then a call of 2 (2); "
        f"{moved} of {K} weights moved, {int((k[1] != dt).sum())} data "
        "cells changed")
    return k


def frontier_bytes(K, L):
    return {"K19": K * (2 * L + 8), "K20": 5 * 8 * K,
            "K21": K * (4 * L + 8)}


def tempered_bytes(dm, K):
    """Least bytes of one tempered round that goes to the tapes in global
    memory: the cells the walk reads and writes, a float32 uniform a
    site, lw read and written."""
    read, written = k1_source.cell_traffic(dm)
    return K * FR_E * (len(read) + len(written) + 4) + 16 * K


def tempered_call_bytes(K, L, n):
    """Least bytes of a resident call of n tempered rounds: the uniforms
    and a shift a round, both rows of every member in and out once, lw
    read and written once."""
    return n * (K * FR_E * 4 + 4) + 4 * K * L + 16 * K


def step_bytes(tab, K, L):
    """Least bytes of one per-step beam step: at M = 1 the window cells
    read and written in place and the weights; at M > 1 the parents' rows
    read, the new tapes written, the weights read and written."""
    if tab.out_cum.shape[1] == 1:
        written = int(tab.wr_mask.any(0).sum())
        return K * (tab.n_cells + written + 16)
    return K * (4 * L + 16)


def island_probs_port(spds, lengths=(1, 2, 3), cl_k=5):
    """ex2_ensemble_crosscheck.py's p(D U^L D) per snapshot, by the
    port's `markov.seq_prob`."""
    return {n: np.array([float(np.squeeze(tmarkov.seq_prob(
        s.reshape((2,) * cl_k), (0, *((1,) * n), 0))[0])) for s in spds])
        for n in lengths}


def crosscheck_example(dev, diff):
    """(d) examples/ex2_ensemble_crosscheck.py's frontier through the
    port: K=8192, L=128, E=4, 4 seeds x 40 snapshots of 32 rounds, held
    to the example's gate (worst relative deviation of the seed mean
    < 0.10) against the exact closure by the port's `solve`."""
    K, L_, E_, rounds, snaps, cl_k = 8192, 128, 4, 32, 40, 5
    dm = ens.compile_decision_machine(EX2)
    p0 = ferromagnet_p0(cl_k, p_pair=1 / 250).ravel()
    dt_round = -math.log1p(-E_ / L_)
    ts = np.arange(snaps + 1) * rounds * dt_round
    fn = trhs.make_dy_dt(tcompile.compile_problem(EX2, cl_k), device=dev)
    exact_ys = solve(lambda y, t: fn(y), p0, ts, rtol=1e-10, atol=1e-12,
                     device=dev)
    exact = island_probs_port(exact_ys)
    t0 = time.perf_counter()
    runs = []
    for seed in range(4):
        gen = torch.Generator(device=dev).manual_seed(5000 + seed)
        dtape = ens.sample_tapes_from_spd(gen, p0, 2, cl_k, K, L_,
                                          device=dev)
        ptape = torch.zeros((K, L_), dtype=torch.int8, device=dev)
        lw = torch.full((K,), -math.log(K), dtype=torch.float64, device=dev)
        spds = [ens.weighted_window_counts(dtape, torch.exp(lw), 2, cl_k,
                                           device=dev).cpu().numpy()]
        for _ in range(snaps):
            (ptape, dtape), lw, _ = tfr.run_weighted_frontier_blocked(
                gen, (ptape, dtape), lw, dm, (1, rounds, E_), device=dev)
            spds.append(ens.weighted_window_counts(
                dtape, torch.exp(lw), 2, cl_k, device=dev).cpu().numpy())
        runs.append(island_probs_port(np.stack(spds)))
    seconds = time.perf_counter() - t0
    worst = 0.0
    for n in (1, 2, 3):
        mean = np.stack([r[n] for r in runs]).mean(axis=0)
        rel = np.abs(mean - exact[n]) / np.maximum(exact[n], 1e-12)
        worst = max(worst, float(rel[1:].max()))
        say(f"(d) L={n}: max rel deviation of the seed mean from exact "
            f"{rel[1:].max():.4f}")
    if not worst < 0.10:
        raise AssertionError(f"(d) frontier diverged from the exact "
                             f"closure: {worst}")
    say(f"(d) ex2_ensemble_crosscheck through the port: worst {worst:.4f} "
        f"< 0.10; 4 seeds x {snaps} snapshots in {seconds:.2f} s")
    return {"worst_rel": worst, "seconds": seconds}


def first_passage_gates(dev, gen, diff):
    """(e) The weighted first-passage harnesses against exact answers:
    (1) `test_weighted_first_passage_matches_unweighted_and_is_tau_
    invariant`'s geometry (K=2048, L=64, E=4, 24 one-round blocks) at tau
    1 and 0.5 against brute force (K12 a round); (2) on the L=12 ring of
    `test_tempered_first_passage_ess_adaptive` (a), against the port's master
    equation (`engine/master.py`), z over 16 seeds: the absorbing
    ESS-adaptive harness at tau 0.5 (checked every round) against the
    survival checked every round (`discrete_survival`), the hit-flagged
    and the binned harness (`test_we_binned_*`'s) at tau 1, which check
    at block ends only, against the survival checked at block ends
    (`block_survival`). The hit-flagged harness at tau < 1 is left out:
    the reference documents it as biased there (merges at block ends
    prune the hit lineages), which is why it has the absorbing mode;
    (3) that test's collapse scenario (b) by its own thresholds; (4) the
    binned harness's unbiasedness at `test_we_binned_*`'s geometry
    (split against no split, z < 6 over 16 seeds each)."""
    out = {}
    dm = ens.compile_decision_machine(EX2)
    K, L_, E_, n_rounds = 2048, 64, 4, 24
    p0 = ferromagnet_p0(4, p_pair=0.05, corrected=True).ravel()
    dtape = ens.sample_tapes_from_spd(gen, p0, 2, 4, K, L_, device=dev)
    ptape = torch.zeros((K, L_), dtype=torch.int8, device=dev)
    lw0 = torch.full((K,), -math.log(K), dtype=torch.float64, device=dev)
    t_hit, _, _ = ens.first_passage_times(gen, (ptape, dtape), dm, (1, 1, 1),
                                          (n_rounds, E_), device=dev)
    t_hit = t_hit.cpu().numpy()
    for tau in (1.0, 0.5):
        (s, ess, t_blocks, _, _, _, nu), sec, la, _ = frontier_path(
            f"e1 tau {tau}", lambda: tfr.weighted_first_passage(
                gen, (ptape, dtape), lw0, dm, (1, 1, 1), (n_rounds, 1, E_),
                tau=tau, device=dev))
        need_launches(f"e1 tau {tau}", la, ["K19", "K20", "K21", "K12"])
        s = s.cpu().numpy()
        z, ok = 0.0, True
        for bi in (n_rounds // 2 - 1, n_rounds - 1):
            s_bf = float((t_hit > t_blocks[bi] + 1e-12).mean())
            se = math.sqrt(max(s_bf * (1 - s_bf), 1e-4) / K)
            z = max(z, abs(float(s[bi]) - s_bf) / se)
            # The JAX test's budget at its two blocks: 10 iid SE (members
            # share sites) plus 0.02 at tau 1, 0.05 at tau 0.5, where the
            # hit-flagged estimator under block-only merging runs high
            # (the reference's documented collapse; (e2)'s absorbing mode
            # is the tempered estimator held to z < 6).
            ok &= abs(float(s[bi]) - s_bf) < 10 * se + (
                0.02 if tau == 1.0 else 0.05)
        say(f"(e1) weighted_first_passage tau {tau} vs brute force at "
            f"K={K}, L={L_}: S(end) {s[-1]:.4f}, max z {z:.2f} "
            f"(iid SE), {sec:.3f} s; launches {la}")
        if not ok:
            raise AssertionError(f"(e1) tau {tau}: z {z}")
        out[f"e1 tau {tau}"] = {"z": z, "seconds": sec}

    # The small ring, exact.
    cl_k, Ls, Ks, rounds = 3, 12, 4096, 60
    spd = ferromagnet_p0(cl_k, p_pair=0.3).reshape((2,) * cl_k)
    pring = tmaster.ring_trace_measure(spd, 2, cl_k, Ls)
    hitmask = tmaster.ring_contains_pattern(Ls, 2, (1, 1, 1))
    Q = tmaster.build_ring_generator(EX2, Ls)
    per_round = tmaster.discrete_survival(Q, pring, hitmask, rounds,
                                          Ls)[15::15]
    at_ends = block_survival(Q, pring, hitmask, 15, 4, Ls)
    lw0 = torch.full((Ks,), -math.log(Ks), dtype=torch.float64, device=dev)
    runs = {"flagged tau 1": (dict(tau=1.0), at_ends),
            "absorbing tau 0.5": (dict(tau=0.5, ess_frac=0.5, check_every=1),
                                  per_round),
            "binned tau 1": (None, at_ends)}
    for name, (kw, want) in runs.items():
        curves = []
        t0 = time.perf_counter()
        for seed in range(16):
            dtape = ens.sample_tapes_from_spd(gen, spd, 2, cl_k, Ks, Ls,
                                              device=dev).to(torch.int8)
            ptape = torch.zeros((Ks, Ls), dtype=torch.int8, device=dev)
            if kw is None:
                s, *_ = tfr.weighted_first_passage_binned(
                    gen, (ptape, dtape), lw0, dm, (1, 1, 1), (4, 15, 1),
                    seed=seed, device=dev)
            else:
                s = tfr.weighted_first_passage(
                    gen, (ptape, dtape), lw0, dm, (1, 1, 1), (4, 15, 1),
                    device=dev, **kw)[0].cpu().numpy()
            curves.append(np.asarray(s))
        seconds = time.perf_counter() - t0
        z = survival_z(curves, want, Ks)
        say(f"(e2) {name} on the L={Ls} ring, 16 seeds x {Ks}: S "
            f"{np.mean(curves, axis=0).round(4).tolist()} against the master "
            f"equation's {np.round(want, 4).tolist()}: z {z:.2f} "
            f"({seconds:.2f} s)")
        if not z < 6:
            raise AssertionError(f"(e2) {name}: z {z}")
        out[name] = {"z": z, "seconds": seconds}
    # (3) test_tempered_first_passage_ess_adaptive's collapse scenario
    # (ex2, K=2048, L=64, E=4, 2 blocks of 128 rounds, six U): tau 0.5
    # with block-end merges only collapses (ESS below K/50, P(hit) below
    # a fifth of the brute-force 0.033), the absorbing ESS-adaptive run
    # holds its ESS above K/2 and P(hit) within 3x. The test reads one run
    # of each; here the adaptive estimate is the mean of 4 runs, its
    # single runs being heavy-tailed (0.007-0.070 seen on the CPU).
    p0b = ferromagnet_p0(4, p_pair=0.05, corrected=True).ravel()
    p_bf = 0.033  # the JAX test's brute force, per-round checks
    got = {"adaptive": []}
    for run in range(4):
        dtape = ens.sample_tapes_from_spd(gen, p0b, 2, 4, K, L_, device=dev)
        ptape = torch.zeros((K, L_), dtype=torch.int8, device=dev)
        lw0 = torch.full((K,), -math.log(K), dtype=torch.float64, device=dev)
        for name, kw in ((("plain", {}),) if run == 0 else ()) + (
                ("adaptive", dict(ess_frac=0.5, check_every=4)),):
            s, ess, *_ = tfr.weighted_first_passage(
                gen, (ptape, dtape), lw0, dm, (1,) * 6, (2, 128, E_),
                tau=0.5, device=dev, **kw)
            res = (1.0 - float(s[-1]), float(ess[-1]))
            if name == "plain":
                got["plain"] = res
            else:
                got["adaptive"].append(res)
    p_ad = float(np.mean([r[0] for r in got["adaptive"]]))
    ess_ad = min(r[1] for r in got["adaptive"])
    say(f"(e3) the collapse scenario at K={K}, L={L_}, 2 x 128 rounds, "
        f"tau 0.5: block-end merges P(hit) {got['plain'][0]:.4f}, ESS "
        f"{got['plain'][1]:.1f}; ESS-adaptive P(hit) "
        f"{[round(r[0], 4) for r in got['adaptive']]}, mean {p_ad:.4f}, "
        f"least ESS {ess_ad:.1f} (brute force {p_bf})")
    if not (got["plain"][1] < K / 50 and got["plain"][0] < p_bf / 5
            and ess_ad > K / 2 and p_bf / 3 < p_ad < 3 * p_bf):
        raise AssertionError(f"(e3) {got}")
    out["e3"] = got
    # (4) test_we_binned_*'s unbiasedness geometry (ex2, K=256, L=64,
    # plan (8, 4, 8), eight U from random tapes): WE splitting against
    # plain Monte Carlo in the same harness (split=False), z on the seeds'
    # scatter.
    finals = {True: [], False: []}
    for split in (True, False):
        for seed in range(16):
            dtp = torch.randint(0, 2, (256, L_), generator=gen, device=dev,
                                dtype=torch.int32)
            surv, _, _, _ = tfr.weighted_first_passage_binned(
                gen, (torch.zeros_like(dtp), dtp),
                torch.full((256,), -math.log(256), dtype=torch.float64,
                           device=dev), dm, (1,) * 8, (8, 4, 8),
                split=split, seed=seed, device=dev)
            finals[split].append(1.0 - surv[-1])
    a, b = (np.asarray(finals[k]) for k in (True, False))
    sem = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b) + 1e-12)
    z = abs(a.mean() - b.mean()) / sem
    say(f"(e4) binned WE at test_we_binned_*'s geometry, 16 seeds each: "
        f"split P(hit) {a.mean():.4f}, plain {b.mean():.4f}: z {z:.2f}")
    if not z < 6:
        raise AssertionError(f"(e4) z {z}")
    out["e4"] = {"z": z, "split": a.mean(), "plain": b.mean()}
    # The absorbing harness reads its ESS trigger on the host once a
    # sub-block (the reference's lax.cond): the read's round trip alone,
    # after a device op as in the harness, and the harness's wall time a
    # sub-block (16 seeds x 60 one-round sub-blocks).
    flag = torch.zeros((), device=dev)
    reps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        bool(torch.isfinite(flag + 1.0))
    read_us = (time.perf_counter() - t0) / reps * 1e6
    sub_us = out["absorbing tau 0.5"]["seconds"] / (16 * 60) * 1e6
    out["ess_read_us"], out["absorbing_sub_block_us"] = read_us, sub_us
    say(f"(e2) the ESS trigger's host read: {read_us:.1f} us (a device op "
        f"and the read); the absorbing harness {sub_us:.1f} us a sub-block "
        f"of one round at K={Ks} (wall, the seeds' tape sampling included)")
    return out


def block_survival(Q, p0, hit_mask, rounds, blocks, L):
    """The exact survival of a harness that checks for the pattern at
    block ends only: `master.discrete_survival`'s kernel I + Q/L each
    round, the pattern's states projected out every ``rounds`` rounds.
    Returns S at the ``blocks`` block ends."""
    keep = ~np.asarray(hit_mask, dtype=bool)
    p = np.where(keep, np.asarray(p0, dtype=np.float64), 0.0)
    out = []
    for _ in range(blocks):
        for _ in range(rounds):
            p = p + (Q @ p) / L
        p = np.where(keep, p, 0.0)
        out.append(p.sum())
    return np.asarray(out)


def frontier_phase(dev, kernels):
    """Phase 12 (module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(1212)
    max_err = {k: 0 for k in FR_KERNELS}
    launches_main = {}
    paths, times = {}, {}

    def diff(name, pairs):
        err = max(float((a.double() - b.double()).abs().nan_to_num(0.0).max())
                  if a.numel() else 0.0 for a, b in pairs)
        same = all(torch.equal(a, b.to(a.dtype)) for a, b in pairs)
        max_err[name] = max(max_err[name], err)
        return same

    # (a) bench_frontier's geometry, three ways, through the entry point.
    dm5 = ens.compile_decision_machine(MAIN_TAG)
    dm2 = ens.compile_decision_machine(EX2)
    plan_a = (FR_BLOCKS_A, FR_ROUNDS, FR_E)
    ways = [("tau 1, default (K14)", dm5, 1.0, None, ["K14", "K15p"]),
            ("tau 1, bitslice=False (K11)", dm5, 1.0, False, ["K11"]),
            ("tau 0.5 (K11 with increments), ex2", dm2, 0.5, None,
             ["K11t"])]
    for label, dm, tau, bsl, need in ways:
        start = frontier_start(gen, FR_K_A, FR_L, 3 if dm is dm5 else 2, dev)
        out, sec, la, ms = frontier_path(
            f"a {label}", lambda: tfr.run_weighted_frontier_blocked(
                gen, (start[0], start[1]), start[2], dm, plan_a, tau=tau,
                bitslice=bsl, device=dev))
        need_launches(f"a {label}", la, ["K19", "K20", "K21"] + need)
        frontier_checks(f"a {label}", out, FR_K_A, FR_L, dm.size_a,
                        FR_BLOCKS_A)
        (pt, dt), lw, nu = out
        parts = merge_alone(lw, pt, dt, FR_STRIDE, gen, dev)
        merge_ms = parts["K19"] + parts["sort"] + parts["K20"] + parts["K21"]
        block_ms = ms / FR_BLOCKS_A
        rate = FR_K_A * FR_ROUNDS * FR_E * FR_BLOCKS_A / (ms * 1e-3)
        paths[f"a {label}"] = {
            "ms_block": block_ms, "merge_ms": merge_ms,
            "merge_share": merge_ms / block_ms, "branch_steps_per_s": rate,
            "n_unique_last": int(nu[-1]), "launches": la, "seconds": sec,
            "merge_parts_ms": parts}
        if tau != 1.0:
            launches_main["K11t"] = la["K11t"]
            want = FR_BLOCKS_A * sum(
                tempered_launches(FR_K_A, FR_L, min(FR_CALL_ROUNDS,
                                                    FR_ROUNDS - k0))
                for k0 in range(0, FR_ROUNDS, FR_CALL_ROUNDS))
            if la["K11t"] != want:
                raise AssertionError(f"a {label}: K11t launches "
                                     f"{la['K11t']}, want {want}")
            say(f"(a) {label}: K11t resident, {FR_CALL_ROUNDS} rounds a "
                f"call, {la['K11t']} launches")
        else:
            for k in ("K19", "K20", "K21"):
                launches_main.setdefault(k, la[k])
        say(f"(a) {label} at K={FR_K_A}, L={FR_L}, plan {plan_a}: "
            f"{block_ms:.3f} ms a block, merge {merge_ms:.3f} ms "
            f"({merge_ms / block_ms:.3f} of a block: K19 {parts['K19']:.3f}, "
            f"sort {parts['sort']:.3f}, K20 {parts['K20']:.3f}, K21 "
            f"{parts['K21']:.3f}), {rate:.4e} branch-steps/s, n_unique "
            f"{int(nu[-1])}; {sec:.3f} s; launches {la}")
        if dm is dm5 and bsl is None:
            frontier_kernels_against_plain("(a)", pt, dt, lw, FR_STRIDE, gen,
                                           diff)
            times["a"] = parts
            for tag in (EX4, EX2):
                dmt = ens.compile_decision_machine(tag)
                p_sym, d_sym = ACTIVE_SYMBOLS.get(tag,
                                                  (range(dmt.size_a),) * 2)
                tp = torch.as_tensor(list(p_sym), dtype=torch.int8,
                                     device=dev)[torch.randint(
                    0, len(p_sym), (FR_K_A, FR_L), generator=gen,
                    device=dev)]
                td = torch.as_tensor(list(d_sym), dtype=torch.int8,
                                     device=dev)[torch.randint(
                    0, len(d_sym), (FR_K_A, FR_L), generator=gen,
                    device=dev)]
                tempered_against_plain(f"(a) {tag}", dmt, tp, td, lw, gen,
                                       diff)
                if tag == EX2:
                    # A call of the block's chunk of rounds (the main
                    # path's, resident) and a one-round call (a launch a
                    # round), each beside its bound.
                    n_call = FR_CALL_ROUNDS
                    shifts = torch.randint(0, FR_STRIDE, (n_call,),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)
                    u = torch.rand((n_call, FR_K_A, FR_E), generator=gen,
                                   device=dev)
                    lwx = lw.clone()
                    t_call = cuda_ms(lambda: tfr.tempered_round(
                        dmt, tp, td, shifts, FR_E, u, 0.5, lwx), 5,
                        warmup=1) / n_call
                    it = iter(range(10**9))
                    t_one = cuda_ms(lambda: tfr.tempered_round(
                        dmt, tp, td, shifts[next(it) % n_call:][:1], FR_E,
                        u[0:1], 0.5, lwx), 50)
                    t_plain = cuda_ms(lambda: ens.lattice_round_plain(
                        dmt, tp, td, shifts[0], FR_E, u[0], tau=0.5,
                        lw=lwx), 3, warmup=1)
                    times["K11t"] = {
                        "ms": t_call, "one_round_ms": t_one,
                        "plain_ms": t_plain, "call_rounds": n_call,
                        "tile": ens.k11_tempered_tile(FR_K_A, FR_L),
                        "bound_ms": tempered_call_bytes(FR_K_A, FR_L, n_call)
                        / n_call / HBM_BYTES_PER_S * 1e3,
                        "one_round_bound_ms": tempered_bytes(dmt, FR_K_A)
                        / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                        "library_ms": None}
                    t = times["K11t"]
                    say(f"K11t alone ({EX2}, K={FR_K_A}, L={FR_L}, "
                        f"E={FR_E}, tau 0.5): a resident call of {n_call} "
                        f"rounds (tile {t['tile']}) {t_call * 1e3:.3f} µs a "
                        f"round against {t['bound_ms'] * 1e3:.3f}; a "
                        f"one-round call (a launch a round) "
                        f"{t_one * 1e3:.3f} µs against "
                        f"{t['one_round_bound_ms'] * 1e3:.3f}; plain "
                        f"{t_plain:.3f} ms")
                    del u, lwx
                del tp, td
        del out, pt, dt, lw, start
        torch.cuda.empty_cache()

    # (b) Config 5: ex2 at K = 10^7 (equal-weight merge, sampling circuit).
    plan_b = (FR_BLOCKS_B, FR_ROUNDS, FR_E)
    start = frontier_start(gen, FR_K_B, FR_L, 2, dev)
    torch.cuda.reset_peak_memory_stats()
    out, sec, la, ms = frontier_path(
        "b", lambda: tfr.run_weighted_frontier_blocked(
            gen, (start[0], start[1]), start[2], dm2, plan_b, device=dev))
    peak = torch.cuda.max_memory_allocated() / 1e9
    need_launches("b", la, ["K19", "K20", "K21", "K14", "K15p"])
    frontier_checks("b", out, FR_K_B, FR_L, dm2.size_a, FR_BLOCKS_B)
    (pt, dt), lw, nu = out
    del start
    parts = merge_alone(lw, pt, dt, FR_STRIDE, gen, dev)
    merge_ms = parts["K19"] + parts["sort"] + parts["K20"] + parts["K21"]
    rate = FR_K_B * FR_ROUNDS * FR_E * FR_BLOCKS_B / (ms * 1e-3)
    paths["b"] = {"ms_block": ms / FR_BLOCKS_B, "merge_ms": merge_ms,
                  "merge_share": merge_ms / (ms / FR_BLOCKS_B),
                  "branch_steps_per_s": rate, "n_unique_last": int(nu[-1]),
                  "peak_gb": peak, "launches": la, "seconds": sec,
                  "merge_parts_ms": parts}
    say(f"(b) config 5, {EX2} at K={FR_K_B}, L={FR_L}, plan {plan_b} "
        f"(equal-weight merge, mode {parts['mode']}): "
        f"{ms / FR_BLOCKS_B:.3f} ms a block, merge {merge_ms:.3f} ms (K19 "
        f"{parts['K19']:.3f}, sort {parts['sort']:.3f}, K20 "
        f"{parts['K20']:.3f}, K21 {parts['K21']:.3f}), {rate:.4e} "
        f"branch-steps/s, n_unique {int(nu[-1])}, peak {peak:.2f} GB; "
        f"{sec:.3f} s; launches {la}")
    frontier_kernels_against_plain("(b)", pt, dt, lw, FR_STRIDE, gen, diff)
    times["b"] = parts
    h = tfr.content_hash(pt, dt, stride=FR_STRIDE, bits=4)
    parent = tfr.merge_resample(h, lw, torch.rand(
        (), generator=gen, dtype=torch.float64, device=dev), 1)[0]
    lib_ms = (cuda_ms(lambda: torch.index_select(pt, 0, parent), 10)
              + cuda_ms(lambda: torch.index_select(dt, 0, parent), 10))
    plain_ms = {
        "K19": cuda_ms(lambda: tfr.content_hash_plain(pt, dt, FR_STRIDE, 4),
                       1, warmup=1),
        "K20": cuda_ms(lambda: tfr.merge_resample_plain(
            *tfr.sort_hashes(h), lw, 0.5, 1, math.log(FR_K_B)), 1, warmup=1),
        "K21": cuda_ms(lambda: tfr.gather_pair_plain(pt, dt, parent), 3)}
    del out, pt, dt, lw, h, parent
    torch.cuda.empty_cache()

    # (c) bench_frontier_per_step's geometry: ex5's table (M = 1; program
    # tapes over 3 symbols, data tapes zero, as the bench) and ex2's (M > 1,
    # the sorted top-k; data tapes over both spins, program tapes zero).
    for tag in (MAIN_TAG, EX2):
        tab = ens.device_table(ens.compile_transition_table(tag), device=dev)
        hi = 3 if tag == MAIN_TAG else 2
        pt = torch.randint(0, hi, (FR_K_C, FR_L_C), generator=gen,
                           device=dev, dtype=torch.int32)
        dt = torch.zeros_like(pt)
        if tag == EX2:
            pt, dt = dt, pt
        lw = torch.full((FR_K_C,), -math.log(FR_K_C), dtype=torch.float64,
                        device=dev)
        (res, sec, la, ms) = frontier_path(
            f"c {tag}", lambda: tfr.run_weighted_frontier(
                gen, (pt, dt), lw, tab, FR_STEPS_C, FR_K_C, device=dev))
        need_launches(f"c {tag}", la, ["K22"])
        launches_main.setdefault("K22", 0)
        launches_main["K22"] += la["K22"]
        (p2, d2), lw2 = res
        if abs(float(torch.logsumexp(lw2, 0))) > 1e-9 or not (
                int(d2.abs().sum()) or int((p2 != pt).sum())):
            raise AssertionError(f"(c) {tag}: weights or tapes")
        M = tab.out_cum.shape[1]
        paths[f"c {tag}"] = {"ms_step": ms / FR_STEPS_C, "M": M,
                             "launches": la, "seconds": sec}
        say(f"(c) per-step beam, {tag}'s table (M={M}) at K={FR_K_C}, "
            f"L={FR_L_C}, {FR_STEPS_C} steps: {ms / FR_STEPS_C:.3f} ms a "
            f"step, {FR_K_C * FR_STEPS_C / (ms * 1e-3):.4e} branch-steps/s; "
            f"launches {la}; {sec:.3f} s")
        # One step against its plain version from the run's weights, from
        # uniform ones (whole groups of children tie) and after a
        # weight-only merge (weights out of order), and K22 alone.
        out_log = tfr._out_log(tab).contiguous()
        p8, d8 = p2.to(torch.int8), d2.to(torch.int8)
        sites = torch.randint(0, FR_L_C, (1,), generator=gen, device=dev,
                              dtype=torch.int32)
        uniform = torch.full_like(lw2, -math.log(FR_K_C))
        merged = tfr._merge_weights_inplace(
            tfr.content_hash(p8, d8, stride=1, bits=8), lw2)
        for start, w0 in (("the run's weights", lw2), ("uniform", uniform),
                          ("after a merge", merged)):
            k = tfr.frontier_step(tab, out_log, p8.clone(), d8.clone(),
                                  w0.clone(), sites, 0)
            want = tfr.frontier_step_plain(tab, out_log, p8.clone(),
                                           d8.clone(), w0.clone(), sites[0])
            if not diff("K22", list(zip(k, want))):
                raise AssertionError(f"K22 != plain on {tag} ({start})")
            say(f"(c) {tag}: one K22 step == plain bit for bit from "
                f"{start}")
            del k, want
        # At M = 1 the step runs in place: the timed steps go on from the
        # last one's tapes.
        bufs = tfr.BeamBuffers(FR_K_C, FR_L_C, M, dev)
        step_ms = cuda_ms(lambda: tfr.frontier_step(
            tab, out_log, p8, d8, lw2, sites, 0, bufs), 10)
        step_plain = cuda_ms(lambda: tfr.frontier_step_plain(
            tab, out_log, p8, d8, lw2, sites[0]), 3)
        split = {name: us * 1e-3 for name, us in time_beam_aug.k22_split(
            lambda: tfr.frontier_step(tab, out_log, p8, d8, lw2, sites, 0,
                                      bufs)).items()}
        t = {"ms": step_ms, "plain_ms": step_plain,
             "bound_ms": step_bytes(tab, FR_K_C, FR_L_C) / HBM_BYTES_PER_S
             * 1e3, "bound_by": "bytes", "library_ms": None,
             "split_ms": split}
        if M > 1:
            child = tfr.frontier_rank_plain(tab, out_log, p8.clone(),
                                            d8.clone(), lw2,
                                            sites[0])[1].reshape(-1)
            t["library_ms"] = cuda_ms(lambda: torch.topk(child, FR_K_C), 10)
            t["torch_sort_ms"] = cuda_ms(lambda: torch.sort(
                child, descending=True, stable=True), 10)
            del child
        calls, names = launch_record(lambda: tfr.frontier_step(
            tab, out_log, p8, d8, lw2, sites, 0, bufs))
        foreign = [n for n in names if "k22_" not in n and "Memset" not in n]
        if foreign or not names:
            raise AssertionError(f"K22's step on {tag} ran {foreign or names}")
        t["kernels_a_step"] = len(names)
        times[f"K22 {tag}"] = t
        say(f"K22 {tag}: {len(names)} kernels a step by the profiler, none "
            f"a library sort or top-k")
        say(f"K22 {tag}: {step_ms:.4f} ms a step, bound "
            f"{t['bound_ms']:.4f} ms; split (ms, the kernels' device time "
            "by the profiler) "
            + (", ".join(f"{n} {v:.4f}" for n, v in split.items())
               or "not measured (the profiler saw no kernel)")
            + "; the parent design's, not measured in this run (step 0: "
            "time_beam_aug.py on the parent, H100 80GB HBM3, 700.00 W) "
            + ", ".join(f"{n} {v:.4f}" for n, v in
                        K22_PARENT_SPLIT[M > 1].items())
            + (f"; torch.sort of the {M * FR_K_C} children "
               f"{t['torch_sort_ms']:.4f}, torch.topk "
               f"{t['library_ms']:.4f}" if M > 1 else ""))
        del bufs, uniform, merged
        del pt, dt, lw, p2, d2, lw2, p8, d8, tab
        torch.cuda.empty_cache()

    # (d) and (e): the examples' and the tests' gates.
    paths["d"] = crosscheck_example(dev, diff)
    paths["e"] = first_passage_gates(dev, gen, diff)

    by = frontier_bytes(FR_K_B, FR_L)
    main = times["b"]
    rows = {
        "K19": {"ms": main["K19"], "plain_ms": plain_ms["K19"],
                "bound_ms": by["K19"] / HBM_BYTES_PER_S * 1e3,
                "library_ms": None},
        "K20": {"ms": main["K20"], "plain_ms": plain_ms["K20"],
                "bound_ms": by["K20"] / HBM_BYTES_PER_S * 1e3,
                "library_ms": None, "sort_ms": main["sort"]},
        "K21": {"ms": main["K21"], "plain_ms": plain_ms["K21"],
                "bound_ms": by["K21"] / HBM_BYTES_PER_S * 1e3,
                "library_ms": lib_ms},
        "K22": times[f"K22 {EX2}"],
        "K11t": times["K11t"],
    }
    for k, t in rows.items():
        say(f"{k}: {t['ms']:.4f} ms against a bound of {t['bound_ms']:.4f} "
            f"ms (bytes; {t['bound_ms'] / t['ms']:.3f} of it); plain "
            f"{t['plain_ms']:.3f} ms; library {t['library_ms']}")
    shapes = {"K19": f"int8 [{FR_K_B}, {FR_L}] x2, 4 bits (config 5)",
              "K20": f"{FR_K_B} members, equal weights (config 5)",
              "K21": f"int8 [{FR_K_B}, {FR_L}] x2 (config 5)",
              "K22": f"{EX2}'s table, K={FR_K_C}, L={FR_L_C}",
              "K11t": f"{EX2}, K={FR_K_A}, L={FR_L}, E={FR_E}, tau 0.5, "
                      f"resident calls of {FR_CALL_ROUNDS} rounds"}
    for k, (name, src, replaces) in FR_KERNELS.items():
        t = rows[k]
        kernels[k] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches_main[k],
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "shape": shapes[k], "detail": t}
    kernels["K19"]["paths"] = paths
    kernels["K19"]["at_a"] = times["a"]
    kernels["K22"]["ex5"] = times[f"K22 {MAIN_TAG}"]


# --- Phase 13: thermodynamics (K23, K24) and the host instruments -----------

TH_B, TH_L, TH_E, TH_ROUNDS = B, L, E, 200  # the ensemble's geometry (a)
EX4V2 = "ex4var2-chemical-turing"
TH_SYMS = ("A", "B", "C", "D", "I", "O", "P", "X", "S", "E")
TH_G = {"A": -1.0, "B": -1.0, "C": -1.0, "D": 1.5, "I": 0.0, "O": 0.0,
        "P": 6.0, "X": 0.0, "S": 0.0, "E": 1.0}  # examples/ex4var2_ledger.py
TH_G_VEC = np.array([TH_G[s] for s in TH_SYMS])
TH_BETA_EFF = 2.0
# examples/ex2_entropy_production.py: ring, snapshots, members.
EP = dict(L=12, E=1, rounds_per_snap=6, snaps=24, B=8192, cl_k=4)
# examples/ex4var2_ledger.py: the ensemble panel and the dual panel.
LG = dict(B=4096, L=128, rounds=512, E=4, chunks=16, dual_cl_k=3)
CE = dict(cl_k=3, ts=np.linspace(0.0, 20.0, 41))  # ex2_closure_error.py
# (d)'s geometries (members, L, E): (a)'s at E 256 and 1, (b)'s and (c)'s.
TH_GEOMS = {"a": (TH_B, TH_L, TH_E), "a, E=1": (TH_B, TH_L, 1),
            "b": (EP["B"], EP["L"], EP["E"]), "c": (LG["B"], LG["L"], LG["E"])}
CE_ARTIFACT_ATOL = 4e-9  # the JAX package's own CPU run: 1.37e-9 off
TH_WRAPPERS = {"K23": tth.sigma_round, "K24": tth.ledger_round}
TH_PLAIN = [tth.sigma_round_plain, tth.ledger_round_plain]
TH_KERNELS = {
    "K23": ("K23 sigma_round", SRC + "thermo_round.cuh",
            "the JAX package's ops/thermo.py:339 run_ensemble_sigma's scan "
            "body (:369-382) with :322 _round_sigma (XLA)"),
    "K24": ("K24 ledger_round", SRC + "thermo_round.cuh",
            "the JAX package's ops/thermo.py:424 run_ensemble_ledger's "
            "scan body (:461-483) (XLA)"),
}


def thermo_path(label, fn):
    """Runs a thermo path with K23's and K24's counts set to 0 just
    before and read just after; raises if a plain version ran. Returns
    (fn's result, launches, device ms by CUDA events, seconds)."""
    for f in TH_WRAPPERS.values():
        f.launches = 0
    for f in TH_PLAIN:
        f.calls = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in TH_WRAPPERS.items()}
    plain = {f.__name__: f.calls for f in TH_PLAIN if f.calls}
    if plain:
        raise AssertionError(f"path {label}: plain calls {plain}")
    return result, launches, start.elapsed_time(end), seconds


def draw_symbols(gen, symbols, probs, shape, dev):
    """int32 symbols drawn with the given probabilities on the card."""
    cum = torch.tensor(np.cumsum(probs)[:-1], dtype=torch.float32, device=dev)
    idx = torch.searchsorted(cum, torch.rand(shape, generator=gen,
                                             device=dev), right=True)
    return torch.tensor(symbols, dtype=torch.int32, device=dev)[idx]


def ising_energy(dtape, J_eff, h):
    """-J_eff sum s s' - h sum s over each ring (symbol 1 = spin +1)."""
    s = dtape.to(torch.float64) * 2 - 1
    return -(J_eff * (s * torch.roll(s, -1, dims=1)).sum(1) + h * s.sum(1))


def thermo_bytes(dm, kernel, B_, E_, n_tab=0):
    """Least bytes of one K23 or K24 round: K23 reads every window cell
    (the rank), K24 the cells the walk reads and those some spec writes
    (their G); both write the cells some spec writes, read a float32
    uniform a site for a machine with choose nodes, the tables once and
    read and write the per-member accumulators."""
    read, written = k1_source.cell_traffic(dm)
    n_read = dm.n_cells if kernel == "K23" else len(set(read) | set(written))
    site = n_read + len(written) + (4 if dm.has_choose else 0)
    if kernel == "K23":
        return B_ * E_ * site + 9 * n_tab + B_ * (16 + 8)
    S = dm.num_specs
    return B_ * E_ * site + 16 * dm.size_a + B_ * (16 + S * (8 + 16))


def thermo_call_bytes(dm, B_, L_, E_, n, kernel="K24", n_tab=0):
    """Least bytes of a resident K24 (or K23) call of n rounds: the
    uniforms (for a machine with choose nodes) and a shift a round, both
    rows of every member in and out once, G once (K23: its ``n_tab``
    table entries, 9 bytes each), and sigma, counts and spec_sig (K23:
    sigma and n_irrev) read and written once."""
    u = B_ * E_ * 4 if dm.has_choose else 0
    if kernel == "K23":
        return n * (u + 4) + 4 * B_ * L_ + 9 * n_tab + 2 * B_ * 12
    return (n * (u + 4) + 4 * B_ * L_ + 16 * dm.size_a
            + 2 * B_ * (8 + 12 * dm.num_specs))


def ledger_launches(dm, B_, L_, E_, rounds, kernel="K24", n_windows=0):
    """K24's (or K23's) launches in a `run_ensemble_ledger` (or
    `run_ensemble_sigma`) of ``rounds`` rounds: the draws in chunks of at
    most `ensemble._RESIDENT_CHUNK` uniforms, a chunk a C call
    (`chunk_launches`)."""
    per = (max(1, min(rounds, ens._RESIDENT_CHUNK // (B_ * E_)))
           if dm.has_choose else rounds)
    tile = (tth.k24_tile(B_, L_, E_, dm.num_specs) if kernel == "K24" else
            tth.k23_tile(B_, L_, E_, dm.num_specs, n_windows))
    return chunk_launches(rounds, per, tile is not None)


def thermo_round_against_plain(label, dm, kernel, tapes, E_, per_member,
                               gen, tabs=None, ledger=None, n=2):
    """n rounds of K23 or K24 against the plain version on the card, bit
    for bit (tapes and accumulators), a round a call (a launch each);
    then a call of 5 rounds more (`sigma_rounds`, `ledger_rounds`:
    resident, one launch, where `k23_tile` or `k24_tile` fits). Returns
    the kernel's state and the largest absolute difference."""
    pt, dt = (t.to(torch.int8).contiguous() for t in tapes)
    B_, L_ = pt.shape
    shifts = torch.randint(-L_, 2 * L_, (n, B_) if per_member else (n,),
                           generator=gen, device=pt.device,
                           dtype=torch.int32)
    u = torch.rand((n, B_, E_), generator=gen, device=pt.device)
    f64, i32 = torch.float64, torch.int32
    if kernel == "K23":
        accs = [torch.zeros(B_, dtype=f64, device=pt.device),
                torch.zeros(B_, dtype=i32, device=pt.device)]
    else:
        S = dm.num_specs
        accs = [torch.zeros(B_, dtype=f64, device=pt.device),
                torch.zeros((B_, S), dtype=i32, device=pt.device),
                torch.zeros((B_, S), dtype=f64, device=pt.device)]
    k = [pt.clone(), dt.clone()] + [a.clone() for a in accs]
    p = [pt.clone(), dt.clone()] + [a.clone() for a in accs]
    for j in range(n):
        if kernel == "K23":
            tth.sigma_round(dm, k[0], k[1], shifts[j], E_, u[j], tabs,
                            *k[2:])
            tth.sigma_round_plain(dm, p[0], p[1], shifts[j], E_, u[j], tabs,
                                  *p[2:])
        else:
            tth.ledger_round(dm, k[0], k[1], shifts[j], E_, u[j], ledger,
                             *k[2:])
            tth.ledger_round_plain(dm, p[0], p[1], shifts[j], E_, u[j],
                                   ledger, *p[2:])
    forms = f"{n} one-round calls"
    n_res = 5
    sh = torch.randint(-L_, 2 * L_, (n_res, B_) if per_member else (n_res,),
                       generator=gen, device=pt.device, dtype=torch.int32)
    ur = torch.rand((n_res, B_, E_), generator=gen, device=pt.device)
    wrapper = TH_WRAPPERS[kernel]
    before = wrapper.launches
    if kernel == "K23":
        tth.sigma_rounds(dm, k[0], k[1], sh, E_, ur, tabs, *k[2:])
        tile = tth.k23_tile(B_, L_, E_, dm.num_specs, tabs[0].shape[0])
    else:
        tth.ledger_rounds(dm, k[0], k[1], sh, E_, ur, ledger, *k[2:])
        tile = tth.k24_tile(B_, L_, E_, dm.num_specs)
    got = wrapper.launches - before
    if got != (1 if tile else n_res):
        raise AssertionError(f"(d) {kernel} {label}: {n_res} rounds in one "
                             f"call, {got} launches")
    for j in range(n_res):
        if kernel == "K23":
            tth.sigma_round_plain(dm, p[0], p[1], sh[j], E_, ur[j], tabs,
                                  *p[2:])
        else:
            tth.ledger_round_plain(dm, p[0], p[1], sh[j], E_, ur[j], ledger,
                                   *p[2:])
    forms += (f", then a call of {n_res} "
              + (f"(resident, tile {tile[0]})" if tile
                 else "(a launch a round)"))
    del ur
    err = max(float((a.double() - b.double()).abs().max()) for a, b in
              zip(k, p))
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        raise AssertionError(f"{kernel} != plain at {label}: {err}")
    changed = int((k[0] != pt).sum() + (k[1] != dt).sum())
    say(f"(d) {kernel} {label}: {forms} == plain bit for bit "
        f"({changed} cells changed"
        + (f", n_irrev {int(k[3].sum())}" if kernel == "K23" else "")
        + ")")
    if not changed:
        raise AssertionError(f"(d) {kernel} {label}: no cell changed")
    return k, err


def thermo_traced_path(label, fn, kernel):
    """`thermo_path` under `torch.profiler`: its four results and a
    summary of the trace (None, said, where the profiler does not
    start): device time by kernel, the host's allocator, launch and sync
    calls and its four costliest calls, the device's busy share of the
    run, and ``kernel``'s first and last five launches' device µs."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        say(f"(a) {label}: no trace ({exc})")
        return thermo_path(label, fn) + (None,)
    try:
        got = thermo_path(label, fn)
    finally:
        prof.stop()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append((ev.key, int(ev.count), float(ev.self_cpu_time_total),
                     float(dev_us)))
    kern = sorted((r for r in rows if r[3] > 0), key=lambda r: -r[3])
    host = {r[0]: (r[1], r[2] / 1e3) for r in rows
            if r[0] in ("cudaMalloc", "cudaFree", "cudaLaunchKernel",
                        "cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaMemcpyAsync")}
    cpu_top = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])[:4]
    host.update({r[0][:40]: (r[1], r[2] / 1e3) for r in cpu_top})
    name = "k23_" if kernel == "K23" else "k24_"
    own = sorted((e.time_range.start, e.time_range.elapsed_us())
                 for e in prof.events()
                 if name in e.name and e.device_type.name == "CUDA")
    ms = got[2]
    busy_ms = sum(r[3] for r in kern if not r[0].startswith("aten::")) / 1e3
    out = {"ms_round": ms / TH_ROUNDS, "run_ms": ms, "device_busy_ms": busy_ms,
           "kernels": [(r[0][:40], r[1], r[3] / 1e3) for r in kern
                       if not r[0].startswith("aten::")][:5],
           "host_ms": host,
           "first_us": [float(t) for _, t in own[:5]],
           "last_us": [float(t) for _, t in own[-5:]]}
    say(f"(a) {label}, traced: device busy {busy_ms:.3f} of {ms:.3f} ms; "
        f"device ms " + "; ".join(f"{k} x{n} {t:.3f}"
                                  for k, n, t in out["kernels"])
        + "; host ms " + "; ".join(f"{k} x{n} {t:.3f}"
                                   for k, (n, t) in host.items())
        + f"; {kernel}'s first launches "
        f"{[round(t, 1) for t in out['first_us']]} µs, last "
        f"{[round(t, 1) for t in out['last_us']]}")
    return got + (out,)


def thermo_repeats(label, fn, kernel, want):
    """The main path's call again (warm), then once more after the
    allocator's cache is emptied (its buffers taken from the card anew,
    as on a first call), each launching ``kernel`` ``want`` times and
    nothing else."""
    out = {}
    for key, what in (("ms_round_warm", "warm"),
                      ("ms_round_emptied", "after empty_cache")):
        if key == "ms_round_emptied":
            torch.cuda.empty_cache()
        _, la, ms, _ = thermo_path(f"{label}, {what}", fn)
        if la[kernel] != want or sum(la.values()) != want:
            raise AssertionError(f"{label}, {what}: launches {la}")
        out[key] = ms / TH_ROUNDS
    say(f"(a) {label}: the same call again {out['ms_round_warm']:.4f} ms a "
        f"round, after empty_cache {out['ms_round_emptied']:.4f}")
    return out


def thermo_full_width(dev, gen, machines, t2):
    """(a): run_ensemble_sigma on ex2 and run_ensemble_ledger on ex4var2
    at the ensemble's geometry, then each kernel alone."""
    dm2, dm4 = machines[EX2], machines[EX4V2]
    tabs2 = tth.device_tables(t2, device=dev)
    ledger = (torch.as_tensor(TH_G_VEC, device=dev),
              torch.as_tensor(TH_G_VEC, device=dev), TH_BETA_EFF)
    out = {}
    # ex2: sigma, with the ring's Ising energy as its bookkeeping check
    # (each flip's sigma is -beta dE at J_eff = 2J, h = -0.25).
    pt2 = torch.zeros((TH_B, TH_L), dtype=torch.int32, device=dev)
    dt2 = torch.randint(0, 2, (TH_B, TH_L), generator=gen, device=dev,
                        dtype=torch.int32)
    def run2():
        return tth.run_ensemble_sigma(gen, (pt2, dt2), dm2, tabs2,
                                      (TH_ROUNDS, TH_E), device=dev)

    (res, la, ms, sec, trace) = thermo_traced_path("a ex2 sigma", run2,
                                                   "K23")
    (p2f, d2f), sigma, nirr, times = res
    want2 = ledger_launches(dm2, TH_B, TH_L, TH_E, TH_ROUNDS, "K23",
                            t2.num_windows)
    if la["K23"] != want2 or la["K24"]:
        raise AssertionError(f"a ex2: launches {la}, want {want2}")
    book = float((sigma - (ising_energy(dt2, 2.0, -0.25)
                           - ising_energy(d2f, 2.0, -0.25))).abs().max())
    if not (book < 1e-8 and int(nirr.sum()) == 0
            and bool(torch.isfinite(sigma).all()) and torch.equal(p2f, pt2)
            and int(d2f.min()) >= 0 and int(d2f.max()) <= 1
            and int((d2f != dt2).sum()) > 0):
        raise AssertionError(f"a ex2: sigma bookkeeping {book}")
    out["ex2"] = {"launches": la, "ms": ms, "ms_round": ms / TH_ROUNDS,
                  "seconds": sec, "book_err": book, "trace": trace,
                  "sigma_mean": float(sigma.mean()),
                  "flips": int((d2f != dt2).sum())}
    say(f"(a) ex2 run_ensemble_sigma B={TH_B}, L={TH_L}, E={TH_E}, "
        f"{TH_ROUNDS} rounds: launches {la} (K23 resident), "
        f"{ms / TH_ROUNDS:.4f} ms a "
        f"round (the first call, draws included), {sec:.3f} s; |sigma - "
        f"beta dH| max {book:.3e}; mean sigma {float(sigma.mean()):.4f}")
    out["ex2"].update(thermo_repeats("ex2 sigma", run2, "K23", want2))
    # ex4var2: the ledger from examples/ex4var2_ledger.py's tape mix.
    pt4 = draw_symbols(gen, [6, 7, 8, 9], [0.45, 0.05, 0.42, 0.08],
                       (TH_B, TH_L), dev)
    dt4 = draw_symbols(gen, [0, 4, 5], [0.08, 0.46, 0.46], (TH_B, TH_L), dev)
    phi0 = tth.tape_potential(pt4, dt4, TH_G_VEC, TH_G_VEC, TH_BETA_EFF)
    def run4():
        return tth.run_ensemble_ledger(gen, (pt4, dt4), dm4, ledger,
                                       (TH_ROUNDS, TH_E), device=dev)

    (res, la, ms, sec, trace4) = thermo_traced_path("a ex4var2 ledger",
                                                    run4, "K24")
    (p4f, d4f), sig4, (counts, spec_sig), _ = res
    want4 = ledger_launches(dm4, TH_B, TH_L, TH_E, TH_ROUNDS)
    if la["K24"] != want4 or la["K23"]:
        raise AssertionError(f"a ex4var2: launches {la}, want {want4}")
    phiT = tth.tape_potential(p4f, d4f, TH_G_VEC, TH_G_VEC, TH_BETA_EFF)
    book4 = float((sig4 - (phi0 - phiT)).abs().max())
    decomp = float((spec_sig.sum(1) - sig4).abs().max())
    if not (book4 < 1e-8 and decomp < 1e-8
            and bool((counts.sum(1) == TH_ROUNDS * TH_E).all())
            and float(sig4.abs().max()) > 0):
        raise AssertionError(f"a ex4var2: bookkeeping {book4}, {decomp}")
    out["ex4var2"] = {"launches": la, "ms": ms, "ms_round": ms / TH_ROUNDS,
                      "seconds": sec, "book_err": book4,
                      "trace": trace4,
                      "decomp_err": decomp,
                      "sigma_mean": float(sig4.mean())}
    say(f"(a) ex4var2 run_ensemble_ledger at the same geometry: launches "
        f"{la}, {ms / TH_ROUNDS:.4f} ms a round (the first call), {sec:.3f} "
        f"s; |sigma - (Phi(0) - Phi(T))| max {book4:.3e}, decomposition "
        f"{decomp:.3e}; mean sigma {float(sig4.mean()):.4f}; counts sum to "
        f"rounds x E; K24 resident, {want4} launches")
    out["ex4var2"].update(thermo_repeats("ex4var2 ledger", run4, "K24",
                                         want4))
    # Each kernel alone on the runs' final tapes, beside K11's round
    # without the sums, its bound and its plain version.
    times = {}
    for kernel, dm, pt, dt, extra in (
            ("K23", dm2, p2f, d2f, t2.sigma.size),
            ("K24", dm4, p4f, d4f, 0)):
        p8, d8 = pt.to(torch.int8), dt.to(torch.int8)
        u = torch.rand((TH_B, TH_E), generator=gen, device=dev)
        sh = torch.randint(0, TH_L, (1,), generator=gen, device=dev,
                           dtype=torch.int32)
        f64 = torch.float64
        if kernel == "K23":
            accs = (torch.zeros(TH_B, dtype=f64, device=dev),
                    torch.zeros(TH_B, dtype=torch.int32, device=dev))
            run = (lambda: tth.sigma_round(dm, p8, d8, sh, TH_E, u, tabs2,
                                           *accs))
            plain = (lambda: tth.sigma_round_plain(dm, p8, d8, sh, TH_E, u,
                                                   tabs2, *accs))
        else:
            S = dm.num_specs
            accs = (torch.zeros(TH_B, dtype=f64, device=dev),
                    torch.zeros((TH_B, S), dtype=torch.int32, device=dev),
                    torch.zeros((TH_B, S), dtype=f64, device=dev))
            run = (lambda: tth.ledger_round(dm, p8, d8, sh, TH_E, u, ledger,
                                            *accs))
            plain = (lambda: tth.ledger_round_plain(dm, p8, d8, sh, TH_E, u,
                                                    ledger, *accs))
        ms_k = cuda_ms(run, 20)
        ms_p = cuda_ms(plain, 2, warmup=1)
        ms_11 = cuda_ms(lambda: ens.lattice_round(dm, p8, d8, sh, TH_E, u),
                        20)
        by = thermo_bytes(dm, kernel, TH_B, TH_E, extra)
        times[kernel] = {"ms": ms_k, "plain_ms": ms_p, "k11_ms": ms_11,
                         "bound_ms": by / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "library_ms": None,
                         "bytes": by}
        t = times[kernel]
        say(f"{kernel} alone ({dm.tag}, B={TH_B}, L={TH_L}, E={TH_E}): "
            f"a one-round call {ms_k:.4f} ms a round against a bound of "
            f"{t['bound_ms']:.4f} ms ({by / 1e6:.2f} MB, bytes; "
            f"{t['bound_ms'] / ms_k:.4f} of it); plain {ms_p:.3f} ms; K11's "
            f"round without the sums {ms_11:.4f} ms; library: none")
        # The main path's form: a resident call of a chunk's rounds.
        n_call = min(TH_ROUNDS, ens._RESIDENT_CHUNK // (TH_B * TH_E))
        shc = torch.randint(0, TH_L, (n_call,), generator=gen,
                            device=dev, dtype=torch.int32)
        uc = torch.rand((n_call, TH_B, TH_E), generator=gen, device=dev)
        if kernel == "K23":
            ms_c = cuda_ms(lambda: tth.sigma_rounds(
                dm, p8, d8, shc, TH_E, uc, tabs2, *accs), 5,
                warmup=1) / n_call
            tile = tth.k23_tile(TH_B, TH_L, TH_E, dm.num_specs,
                                t2.num_windows)
        else:
            ms_c = cuda_ms(lambda: tth.ledger_rounds(
                dm, p8, d8, shc, TH_E, uc, ledger, *accs), 5,
                warmup=1) / n_call
            tile = tth.k24_tile(TH_B, TH_L, TH_E, dm.num_specs)
        byc = thermo_call_bytes(dm, TH_B, TH_L, TH_E, n_call, kernel, extra)
        t.update({"one_round_ms": ms_k, "one_round_bound_ms":
                  t["bound_ms"], "one_round_bytes": by, "ms": ms_c,
                  "bound_ms": byc / n_call / HBM_BYTES_PER_S * 1e3,
                  "bytes": byc, "call_rounds": n_call, "tile": tile})
        say(f"{kernel} alone, a resident call of {n_call} rounds (tile "
            f"{t['tile']}): {ms_c:.4f} ms a round against a bound of "
            f"{t['bound_ms']:.4f} ms ({byc / 1e6:.2f} MB a call; "
            f"{t['bound_ms'] / ms_c:.4f} of it)")
        del uc
        del p8, d8, u, accs
    del pt2, dt2, p2f, d2f, pt4, dt4, p4f, d4f, counts, spec_sig
    torch.cuda.empty_cache()
    return out, times


def entropy_example(dev, gen, dm2, t2):
    """(b): the ensemble side of examples/ex2_entropy_production.py at
    its geometry through the port's generator, held to the gates of
    tests/test_thermo.py:432 (z < 6 at every snapshot against the exact
    kernel's expectation, the IFT within 6 se, mean sig_tot > 0)."""
    import scipy.sparse as sp

    Lr, a, cl_k, Bm = EP["L"], dm2.size_a, EP["cl_k"], EP["B"]
    spd = np.full((a,) * cl_k, 1.0 / a**cl_k)
    Q = tmaster.build_ring_generator(EX2, Lr)
    S = a**Lr
    K = (sp.identity(S) + Q / Lr).tocsr()
    p0_states = tmaster.ring_trace_measure(spd, a, cl_k, Lr)
    digits = tmaster._ring_digits(Lr, a)

    def window_marginals(p):
        pw = np.zeros(t2.num_windows)
        for i in range(Lr):
            wr = np.zeros(S, dtype=np.int64)
            for off in range(dm2.d_lo, dm2.d_lo + dm2.n_d):
                wr = wr * a + digits[:, (i + off) % Lr]
            for pd in range(a**dm2.n_p):
                np.add.at(pw, pd * (a**dm2.n_d) + wr, p / (a**dm2.n_p))
        return pw / Lr

    p, acc, exp_cum = p0_states.copy(), 0.0, [0.0]
    for _ in range(EP["snaps"]):
        for _ in range(EP["rounds_per_snap"]):
            rate, _ = tth.medium_entropy_rate_from_window_probs(
                window_marginals(p), t2)
            acc += rate * EP["E"]
            p = K @ p
        exp_cum.append(acc)
    exp_cum = np.asarray(exp_cum)
    tabs = tth.device_tables(t2, device=dev)
    dtape = ens.sample_tapes_from_spd(gen, spd, a, cl_k, Bm, Lr, ring=True,
                                      device=dev)
    ptape = torch.zeros_like(dtape)
    pows = torch.tensor([a ** (Lr - 1 - j) for j in range(Lr)],
                        dtype=torch.int64, device=dev)

    def ranks(tape):
        return (tape.to(torch.int64) * pows).sum(1).cpu().numpy()

    ln_p0 = np.log(p0_states[ranks(dtape)])

    def run():
        sig = torch.zeros(Bm, dtype=torch.float64, device=dev)
        pt, dt_ = ptape, dtape
        mean, se, nirr = [0.0], [0.0], 0
        for _ in range(EP["snaps"]):
            (pt, dt_), ds, ni, _ = tth.run_ensemble_sigma(
                gen, (pt, dt_), dm2, tabs, (EP["rounds_per_snap"], EP["E"]),
                independent_sites=True, device=dev)
            sig = sig + ds
            nirr += int(ni.sum())
            mean.append(float(sig.mean()))
            se.append(float(sig.std(correction=0)) / math.sqrt(Bm))
        return sig, dt_, np.asarray(mean), np.asarray(se), nirr

    (sig, dtf, mean, se, nirr), la, ms, sec = thermo_path("b", run)
    want = EP["snaps"] * ledger_launches(dm2, Bm, Lr, EP["E"],
                                         EP["rounds_per_snap"], "K23",
                                         t2.num_windows)
    if la["K23"] != want or nirr:
        raise AssertionError(f"b: launches {la} (want {want}), n_irrev "
                             f"{nirr}")
    z = np.abs(mean[1:] - exp_cum[1:]) / np.maximum(se[1:], 1e-12)
    sig_tot = (sig.cpu().numpy() + ln_p0
               - np.log(np.maximum(p[ranks(dtf)], 1e-300)))
    ift = np.exp(-sig_tot)
    ift_mean, ift_se = float(ift.mean()), float(ift.std() / math.sqrt(Bm))
    say(f"(b) ex2_entropy_production's ensemble (B={Bm}, L={Lr}, E=1, "
        f"{EP['snaps']} snapshots of {EP['rounds_per_snap']} rounds, "
        f"independent sites): launches {la}, {ms:.1f} ms; final cum sigma "
        f"{mean[-1]:.4f} +- {se[-1]:.4f} against {exp_cum[-1]:.4f}; "
        f"max z {float(z.max()):.3f}; IFT {ift_mean:.4f} +- {ift_se:.4f}; "
        f"mean sig_tot {float(sig_tot.mean()):.4f}")
    if not (float(z.max()) < Z_GATE and abs(ift_mean - 1.0) < 6 * ift_se
            and float(sig_tot.mean()) > 0.0):
        raise AssertionError("b: the entropy-production gates fail")
    return {"z_max": float(z.max()), "cum_mean": mean[-1],
            "exp_cum": float(exp_cum[-1]), "ift_mean": ift_mean,
            "ift_se": ift_se, "sig_tot_mean": float(sig_tot.mean()),
            "launches": la, "ms": ms, "seconds": sec}


def ledger_example(dev, gen, dm4):
    """(c): examples/ex4var2_ledger.py's ensemble panel (K24, 16 calls)
    and its dual panel (cl_k 3 through the card's dense dual RHS), held
    to the claims of tests/test_thermo.py:387 and the dual trajectory to
    examples/ex4var2_ledger_dual.npz."""
    Bm, Lr, Er = LG["B"], LG["L"], LG["E"]
    ledger = (TH_G_VEC, TH_G_VEC, TH_BETA_EFF)
    pt0 = draw_symbols(gen, [6, 7, 8, 9], [0.45, 0.05, 0.42, 0.08], (Bm, Lr),
                       dev)
    dt0 = draw_symbols(gen, [0, 4, 5], [0.08, 0.46, 0.46], (Bm, Lr), dev)
    phi0 = tth.tape_potential(pt0, dt0, *ledger)

    def run():
        S = dm4.num_specs
        sig = torch.zeros(Bm, dtype=torch.float64, device=dev)
        counts = torch.zeros((Bm, S), dtype=torch.int64, device=dev)
        spec_sig = torch.zeros((Bm, S), dtype=torch.float64, device=dev)
        pt, dt_ = pt0, dt0
        for _ in range(LG["chunks"]):
            (pt, dt_), ds, (dc, dss), _ = tth.run_ensemble_ledger(
                gen, (pt, dt_), dm4, ledger,
                (LG["rounds"] // LG["chunks"], Er), device=dev)
            sig += ds
            counts += dc
            spec_sig += dss
        return pt, dt_, sig, counts, spec_sig

    (pt, dt_, sig, counts, spec_sig), la, ms, sec = thermo_path("c", run)
    want = LG["chunks"] * ledger_launches(dm4, Bm, Lr, Er,
                                          LG["rounds"] // LG["chunks"])
    if la["K24"] != want:
        raise AssertionError(f"c: launches {la}, want {want}")
    phiT = tth.tape_potential(pt, dt_, *ledger)
    book = float((sig - (phi0 - phiT)).abs().max())
    decomp = float((spec_sig.sum(1) - sig).abs().max())
    counts = counts.cpu().numpy()
    tot_counts = counts.sum(0)
    sigma_spec = np.where(tot_counts > 0, spec_sig.sum(0).cpu().numpy()
                          / np.maximum(tot_counts, 1), 0.0)
    mask, val = tth._machine_write_specs(dm4)
    advance = np.array([any(mask[s, c] and TH_SYMS[val[s, c]] == "X"
                            for c in range(dm4.n_p))
                        for s in range(dm4.num_specs)])
    adv = advance & (tot_counts > 0)
    prev = {"B": "A", "C": "B", "D": "C"}
    strokes = []
    for s in np.flatnonzero(adv):
        nxt = TH_SYMS[val[s, dm4.n_p + 1 - dm4.d_lo]]
        want = TH_BETA_EFF * ((TH_G["P"] - TH_G["X"]) + TH_G[prev[nxt]]
                              - TH_G[nxt])
        strokes.append((nxt, float(sigma_spec[s]), want))
    if not (book < 1e-8 and decomp < 1e-8 and adv.any()
            and all(abs(g - w) < 1e-9 and min(abs(g - 12.0), abs(g - 7.0))
                    < 1e-9 for _, g, w in strokes)):
        raise AssertionError(f"c: book {book}, decomp {decomp}, strokes "
                             f"{strokes}")
    say(f"(c) ex4var2_ledger's ensemble (B={Bm}, L={Lr}, E={Er}, "
        f"{LG['rounds']} rounds in {LG['chunks']} calls): launches {la}, "
        f"{ms:.1f} ms; book_err {book:.3e}, decomp_err {decomp:.3e}; "
        f"{int(counts[:, adv].sum())} fuel strokes of {int(counts.sum())} "
        f"events at {sorted({round(g, 6) for _, g, _ in strokes})} nats")
    # The dual panel through the card's dense dual RHS (K3, K5).
    cl_k, a = LG["dual_cl_k"], dm4.size_a
    dual = tdense.compile_dense_dual(EX4V2, cl_k)
    fn = tdense.make_dense_dy_dt(dual, jit=False, device=dev)
    p0 = chemical_turing_v2_p0(cl_k).ravel()
    ts = np.concatenate([[0.0], np.geomspace(0.1, 2000.0, 40)])
    t0 = time.perf_counter()
    ys = solve(lambda y, t: fn(y), np.concatenate([p0, p0]), ts,
               rtol=1e-10, atol=1e-13, device=dev)
    solve_s = time.perf_counter() - t0
    ref = np.load(EXAMPLES / "ex4var2_ledger_dual.npz")
    dual_err = float(np.abs(ys - ref["ode_ys"]).max())
    half = a**cl_k

    def mean_g(spd):
        return float(spd.reshape((a,) * cl_k).sum(axis=(1, 2)) @ TH_G_VEC)

    def entropy(spd):
        return float(tmarkov.markov_entropy(spd.reshape((a,) * cl_k)))

    gsum = np.array([mean_g(y[:half]) + mean_g(y[half:]) for y in ys])
    s_sum = np.array([entropy(y[:half]) + entropy(y[half:]) for y in ys])
    heat = TH_BETA_EFF * (gsum[0] - gsum)
    dS = s_sum - s_sum[0]
    F = TH_BETA_EFF * gsum - s_sum
    w = np.exp(-TH_BETA_EFF * TH_G_VEC)
    p1 = w / w.sum()
    gb = p1
    for _ in range(cl_k - 1):
        gb = np.multiply.outer(gb, p1)
    gb = gb.ravel()
    F_gibbs = TH_BETA_EFF * 2 * mean_g(gb) - 2 * entropy(gb)
    gibbs_res = float(fn(np.concatenate([gb, gb])).abs().max())
    say(f"(c) dual panel (cl_k {cl_k}, {len(ts)} samples, card RHS): solve "
        f"{solve_s:.3f} s, max |y - ex4var2_ledger_dual.npz| {dual_err:.3e}; "
        f"F {F[0]:.4f} -> {F[-1]:.4f} (F_gibbs {F_gibbs:.4f}), max dF "
        f"{float(np.diff(F).max()):.3e}; gibbs_res {gibbs_res:.3e}; heat "
        f"{heat[-1]:.4f}, dS {dS[-1]:.4f}")
    if not (dual_err < DUAL_ABS and gibbs_res < 1e-8
            and (np.diff(F) <= 1e-9).all() and F[-1] >= F_gibbs - 1e-9
            and heat[-1] > 0 and heat[-1] > dS[-1]):
        raise AssertionError("c: the dual panel's claims fail")
    return {"book_err": book, "decomp_err": decomp, "strokes": strokes,
            "launches": la, "ms": ms, "seconds": sec, "dual_err": dual_err,
            "gibbs_res": gibbs_res, "solve_s": solve_s}


def closure_example(dev):
    """(e): examples/ex2_closure_error.py's computation through the
    port's closure on the card's RHS and on the CPU: the card's rows
    within rtol 1e-8, atol 1e-14 of the CPU's and within
    CE_ARTIFACT_ATOL of the committed npz; the example's gates."""
    k, ts = CE["cl_k"], CE["ts"]

    def rows(d):
        fns, ps = [], []
        for kk in (k, k + 1):
            fn = trhs.make_dy_dt(tcompile.compile_problem(EX2, kk), device=d)
            fns.append(fn)
            ps.append(solve(lambda y, t, fn=fn: fn(y),
                            ferromagnet_p0(kk, p_pair=1 / 250).ravel(), ts,
                            rtol=1e-11, atol=1e-14, device=d))
        nus, integ = tclosure.integrate_defect(
            EX2, k, ts, ps[0], compiled_pair=(fns[0], fns[1], 2))
        gaps = np.array([np.abs(ps[1][i].reshape((2,) * (k + 1)).sum(-1)
                                .ravel() - ps[0][i]).sum()
                         for i in range(len(ts))])
        return np.stack([nus, integ, gaps])

    t0 = time.perf_counter()
    card = rows(dev)
    card_s = time.perf_counter() - t0
    cpu = rows(torch.device("cpu"))
    art = np.load(EXAMPLES / "ex2_closure_error.npz")["rows"]
    err_cpu = float((np.abs(card - cpu)
                     / (1e-14 + 1e-8 * np.abs(cpu))).max())
    err_art = float(np.abs(card - art).max())
    ratio = card[1, 1:] / card[2, 1:]
    say(f"(e) ex2_closure_error (cl_k 3 and 4, {len(ts)} samples): card "
        f"{card_s:.2f} s; card against CPU {err_cpu:.3f} of rtol 1e-8 + "
        f"atol 1e-14; max |card - npz| {err_art:.3e} (held to "
        f"{CE_ARTIFACT_ATOL}); integral/gap {ratio.min():.2f}-"
        f"{ratio.max():.2f}")
    if not (err_cpu <= 1.0 and err_art < CE_ARTIFACT_ATOL
            and (ratio >= 1.0).all() and (ratio <= 10.0).all()):
        raise AssertionError("e: the closure-error rows fail")
    return {"card_s": card_s, "err_cpu": err_cpu, "err_artifact": err_art,
            "ratio": [float(ratio.min()), float(ratio.max())]}


def thermo_against_plain(dev, gen, machines, t2):
    """(d): each kernel against its plain version at every geometry of
    phase 13's runs (`TH_GEOMS`), shared and per-member shifts: K23 on
    ex2 and ex4 (irreversible: n_irrev > 0), K24 on ex4var2 and ex2.
    Returns the largest difference a kernel, at (a)'s shape and machine
    with shared shifts (the main path's) and over all."""
    t0 = time.perf_counter()
    t4 = tth.sigma_spec_tables(machines[EX4])
    say(f"(d) ex4-chemical-turing's tables ({t4.num_windows} windows x "
        f"{machines[EX4].num_specs} specs, {int(t4.irrev.sum())} "
        f"irreversible) built in {time.perf_counter() - t0:.1f} s on the "
        f"host")
    tabs = {EX2: tth.device_tables(t2, device=dev),
            EX4: tth.device_tables(t4, device=dev)}
    ledgers = {EX4V2: (torch.as_tensor(TH_G_VEC, device=dev),
                       torch.as_tensor(TH_G_VEC, device=dev), TH_BETA_EFF),
               EX2: (torch.tensor([0.3, -0.7], dtype=torch.float64,
                                  device=dev),
                     torch.tensor([-1.1, 0.45], dtype=torch.float64,
                                  device=dev), 1.5)}
    p_sym, d_sym = ACTIVE_SYMBOLS[EX4]
    mixes = {EX2: ([0, 1], [0.5, 0.5], [0, 1], [0.5, 0.5]),
             EX4: (list(p_sym), [1 / len(p_sym)] * len(p_sym),
                   list(d_sym), [1 / len(d_sym)] * len(d_sym)),
             EX4V2: ([6, 7, 8, 9], [0.4, 0.3, 0.2, 0.1], [0, 1, 2, 3, 4, 5],
                     [0.1, 0.1, 0.1, 0.1, 0.3, 0.3])}
    err = {"main": {"K23": None, "K24": None}, "all": {"K23": 0.0,
                                                       "K24": 0.0}}
    main = {"K23": EX2, "K24": EX4V2}
    for geo, (Bd, Ld, E_) in TH_GEOMS.items():
        for per_member in (False, True):
            where = (f"{geo} [{Bd}, {Ld}] E={E_}, "
                     f"{'per-member' if per_member else 'shared'}")
            for kernel, tag in (("K23", EX2), ("K23", EX4), ("K24", EX4V2),
                                ("K24", EX2)):
                ps, pp, ds, dp = mixes[tag]
                tapes = (draw_symbols(gen, ps, pp, (Bd, Ld), dev),
                         draw_symbols(gen, ds, dp, (Bd, Ld), dev))
                k, e = thermo_round_against_plain(
                    f"{tag} {where}", machines[tag], kernel, tapes, E_,
                    per_member, gen, tabs=tabs.get(tag),
                    ledger=ledgers.get(tag), n=4 if tag == EX4 else 2)
                if tag == EX4 and int(k[3].sum()) == 0:
                    raise AssertionError(f"(d) ex4 {where}: no irreversible "
                                         f"event")
                err["all"][kernel] = max(err["all"][kernel], e)
                if geo == "a" and not per_member and tag == main[kernel]:
                    err["main"][kernel] = e
                del tapes, k
    del tabs, t4
    torch.cuda.empty_cache()
    return err


def thermo_phase(dev, kernels, machines):
    """Phase 13 (module docstring)."""
    gen = torch.Generator(device=dev).manual_seed(1313)
    dm2, dm4 = machines[EX2], machines[EX4V2]
    t2 = tth.sigma_spec_tables(dm2)
    paths, times = thermo_full_width(dev, gen, machines, t2)
    paths["b"] = entropy_example(dev, gen, dm2, t2)
    paths["c"] = ledger_example(dev, gen, dm4)
    err = thermo_against_plain(dev, gen, machines, t2)
    paths["e"] = closure_example(dev)
    shapes = {"K23": f"{EX2}, int8 [{TH_B}, {TH_L}] x2, E={TH_E}",
              "K24": f"{EX4V2}, int8 [{TH_B}, {TH_L}] x2, E={TH_E}"}
    for k, (name, src, replaces) in TH_KERNELS.items():
        t = times[k]
        main = paths["ex2" if k == "K23" else "ex4var2"]
        kernels[k] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main["launches"][k],
            "max_abs_err": err["main"][k],
            "max_abs_err_all_shapes": err["all"][k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": shapes[k],
            "k11_ms": t["k11_ms"], "run_ms_per_round": main["ms_round_warm"],
            "run_ms_per_round_first_call": main["ms_round"],
            "detail": t}
    kernels["K23"]["paths"] = paths


# --- Phase 14: forward-mode derivatives (K25, K26, K6's Kvaerno rows) -------

K25 = ("K25 dense_jvp", SRC + "dense_rhs.cu",
       "jax.jvp of the JAX package's engine/dense.py:441 dy_dt_dense at "
       "ode/steady.py:347,525 and ode/kvaerno3.py:79 (XLA)")
K26 = ("K26 steady_aug", SRC + "steady_aug.cu",
       "the JAX package's ode/steady.py:175-183 _ctcp, :232-249 _cons_vals, "
       "_cons_embed and the normalization (XLA)")
K6_KV = ("K6 dop853_arith: Kvaerno 3(2) rows, Newton and error sums, "
         "residual", SRC + "dop853.cu",
         "the JAX package's ode/kvaerno3.py:54 _newton_stage, :99 "
         "odeint_kvaerno3 body (XLA)")
# (tag, cl_k, dual): phase 6's ex4 programs, ex4var2 at cl_k 5 (100,000
# states), ex2 at cl_k 8, ex1's corner rule and a dual program.
JVP_CASES = [(EX4, 5, False), (EX4, 8, False), (EX4V2, 5, False),
             (EX2, 8, False), ("ex1-radioactive-decay", 3, False),
             (EX3, 5, True)]
JVP_TIMED = ((EX4, 5), (EX4, 8))  # the kernels line's first, then bracketed
KV_CL_K = 5
KV_TS = np.linspace(0.0, 10.0, 5)
KV_STEADY = dict(ex2=3, ex2_wide=6, ex4v2=3)
CORR_CL_K, CORR_BETAS = 4, np.linspace(0.2, 1.2, 11)
CORR_DETAIL, CORR_DS = (0.4, 0.8, 1.2), np.arange(1, 31)
DERIV_PLAIN = [tdense.dense_jvp_plain, tdense.sweep_plain,
               tdense.signature_weights_plain, tdense.pyramid_plain,
               tsteady.steady_aug_plain, dop853.resid_plain, *dop853.PLAIN]


AUG_FORM = tsteady.aug_form  # K26's chooser, restored after each swap


def deriv_counts():
    return {"K25": tdense.dense_jvp.launches, "K26": tsteady.steady_aug.launches,
            "K3": tdense.pyramid.launches, "K5": tdense.sweep.launches,
            "K6": sum(f.launches for f in dop853.KERNELS)
            + dop853.resid.launches,
            "plain": sum(f.calls for f in DERIV_PLAIN)}


def zero_deriv_counts():
    for f in (tdense.dense_jvp, tsteady.steady_aug, tdense.pyramid,
              tdense.sweep, dop853.resid, *dop853.KERNELS):
        f.launches = 0
    for f in DERIV_PLAIN:
        f.calls = 0


def k25_bytes(dp):
    """Least bytes of one K25 launch: J v written once; each distinct
    entry of p and v and of their levels that the live windows read,
    once; the pair-valued signature weights; the plan."""
    prog, plan = dp.prog, dp.plan
    return (8 * prog.state_size + 16 * k5_reads(dp)
            + 16 * prog.num_signatures + plan.items.nbytes
            + plan.phase_ptr.nbytes + plan.table.nbytes)


def iid_state(gen, a, k, tapes, dev):
    """A positive, marginally consistent state: on each tape the product
    of k draws of one random symbol distribution. Consistency keeps each
    guarded ratio's numerator below its denominator: the n < d branch."""
    out = []
    for _ in range(tapes):
        sym = -torch.log1p(-torch.rand(a, generator=gen, device=dev,
                                       dtype=torch.float64))
        sym = sym / sym.sum()
        p = sym
        for _ in range(k - 1):
            p = torch.outer(p, sym).reshape(-1)
        out.append(p)
    return torch.cat(out)


def skewed_state(gen, a, k, tapes, dev):
    """A positive state whose left and right marginals differ: on each
    tape the first symbol drawn from q1(x) ~ 0.05^x, the others uniform,
    each window times a draw from [0.8, 1.2]. A left ratio of level 2 or
    more is about R = q1(x1) / (A q1(x2)): above 1 by a factor of 2 or
    more where x2 > x1 (the n > d branch, whose tangent K25 writes as
    exactly 0), below 1 by a factor of A where x2 <= x1; the noise moves
    a ratio by at most 1.5x, so no near-tie is left for a central
    difference to cross (`ratio_margin` checks it on the state drawn).
    A random SPD's near-ties at cl_k 8's 43 M windows make a central
    difference cross a kink of max(n, d) somewhere."""
    q1 = 0.05 ** torch.arange(a, dtype=torch.float64, device=dev)
    q1 = q1 / q1.sum()
    flat = torch.full((a,), 1.0 / a, dtype=torch.float64, device=dev)
    out = []
    for _ in range(tapes):
        p = q1
        for _ in range(k - 1):
            p = torch.outer(p, flat).reshape(-1)
        p = p * (0.8 + 0.4 * torch.rand(a**k, generator=gen, device=dev,
                                        dtype=torch.float64))
        out.append(p / p.sum())
    return torch.cat(out)


def ratio_margin(dp, p, v, low, vlow):
    """Every guarded ratio g(n, d) the sweep and K4 can form at ``p`` (on
    each tape, each level's left ratios and the right ratios; K4's chain
    pairs), with tangents along ``v``: ``(above, total, margin)``, the
    ratios with n > d, all of them, and the least of |n - d| / |dn - dd|
    and n / |dn|. A central difference of step eps crosses no kink of
    max(n, d), nor n = 0, while eps is below the margin."""
    prog = dp.prog
    a, k = prog.size_a, prog.cl_k
    size = a**k

    def ratios():
        for t in range(1 + prog.dual):
            pt, vt = p[t * size:(t + 1) * size], v[t * size:(t + 1) * size]
            lv = [pt.reshape(a**j, -1).sum(1) for j in range(k)] + [pt]
            dv = [vt.reshape(a**j, -1).sum(1) for j in range(k)] + [vt]
            for j in range(1, k + 1):
                yield lv[j], lv[j - 1].repeat(a), dv[j], dv[j - 1].repeat(a)
            yield (pt, torch.repeat_interleave(lv[k - 1], a), vt,
                   torch.repeat_interleave(dv[k - 1], a))
        pyr, dpyr = torch.cat([p, low]), torch.cat([v, vlow])
        num, den = dp.pair_num.long(), dp.pair_den.long()
        yield pyr[num], pyr[den], dpyr[num], dpyr[den]

    above = total = 0
    margin = math.inf
    for n, d, dn, dd in ratios():
        above += int((n > d).sum())
        total += n.numel()
        step = (dn - dd).abs()
        cross = torch.where(step > 0, (n - d).abs() / step, math.inf)
        zero = torch.where(dn != 0, n / dn.abs(), math.inf)
        margin = min(margin, float(cross.min()), float(zero.min()))
    return above, total, margin


def jvp_against_plain(dev, gen, record):
    """(a) K25 against its plain version, bit for bit, on every program of
    JVP_CASES at two positive p (`iid_state`, every guarded ratio's n
    below its d; `skewed_state`, n above d at many) and at a random one
    with a third of its windows zeroed (ties, dead contexts); the value
    path's dy equal to the RHS's (K5) bits; a central difference as the
    witness at the positive p, where no kink lies within its step
    (`ratio_margin`); each call one K25 launch, and K3 once a tape on v
    in the grid form (none in the block and cluster forms, whose launch
    forms v's levels), counted; K25 and K5 bit for bit in every form the
    program can take (`dense.forms_for`), the levels of p given and made
    in the call."""
    record["K25_fd"] = []
    for tag, k, dual in JVP_CASES:
        prog = (tdense.compile_dense_dual(tag, k) if dual
                else tdense.compile_dense(tag, k))
        dp = tdense.device_program(prog, dev)
        n, a = prog.state_size, prog.size_a
        tapes = 1 + dual
        chosen = dp.form
        k3_jvp = 0 if chosen.fused_levels else tapes * \
            tdense.pyramid_launches(a, k)
        say(f"K25 {tag} cl_k {k}{' dual' if dual else ''}: the "
            f"{tdense.form_name(chosen)} form "
            f"({tdense.launch_elements(prog, dp.plan)} elements in the "
            f"largest phase); a J v {1 + k3_jvp} launches (K25 1, K3 "
            f"{k3_jvp}), a forward-mode dual call "
            f"{1 + (0 if chosen.fused_levels else 2 * k3_jvp)}")
        for which in ("consistent", "skewed", "zeroed"):
            if which == "consistent":
                p = iid_state(gen, a, k, tapes, dev)
            elif which == "skewed":
                p = skewed_state(gen, a, k, tapes, dev)
            else:
                p = device_spd(gen, n, dev)
                p = torch.where(torch.rand(n, generator=gen, device=dev,
                                           dtype=torch.float64) < 1 / 3,
                                0.0, p)
                p = p / p.sum()
            z = torch.randn(n, generator=gen, device=dev,
                            dtype=torch.float64)
            v = z / n if which == "zeroed" else z * p
            low = tdense.pyramids(prog, p)
            zero_deriv_counts()
            jv = tdense.dense_jvp(dp, p, v, low)
            c = deriv_counts()
            want = {"K25": 1, "K3": k3_jvp}
            if c["K25"] != 1 or c["K3"] != want["K3"] or c["plain"]:
                raise AssertionError(f"{tag} cl_k {k}: launches {c}, want "
                                     f"{want}")
            plain = tdense.dense_jvp_plain(dp, p, v, low)
            dy, jv2 = tdense.dense_jvp(dp, p, v, low, value=True)
            rhs = tdense.dense_rhs(dp, p)
            torch.cuda.synchronize()
            record["K25"] = max(record["K25"],
                                float((jv - plain).abs().max()))
            if not (torch.equal(jv, plain) and torch.equal(jv2, jv)
                    and torch.equal(dy, rhs)):
                raise AssertionError(f"K25 != plain on {tag} cl_k {k} "
                                     f"({which})")
            for form in tdense.forms_for(dp):
                dp.form = form
                jv_f = tdense.dense_jvp(dp, p, v, low)
                dy_f, jv_f2 = tdense.dense_jvp(dp, p, v, value=True)
                rhs_f = tdense.dense_rhs(dp, p)
                k5_f = tdense.sweep(dp, p, low)
                torch.cuda.synchronize()
                if not (torch.equal(jv_f, plain) and torch.equal(jv_f2, plain)
                        and torch.equal(dy_f, rhs) and torch.equal(rhs_f, rhs)
                        and torch.equal(k5_f, rhs)):
                    raise AssertionError(
                        f"{tag} cl_k {k} ({which}): K25 or K5 in the "
                        f"{tdense.form_name(form)} form differs")
                del jv_f, dy_f, jv_f2, rhs_f, k5_f
            dp.form = chosen
            extra = ""
            if which != "zeroed":
                eps = 1e-6
                above, total, margin = ratio_margin(
                    dp, p, v, low, tdense.pyramids(prog, v))
                if not margin > 2 * eps:
                    raise AssertionError(f"{tag} cl_k {k} ({which}): a kink "
                                         f"within {margin} of p along v")
                if which == "skewed" and not above:
                    raise AssertionError(f"{tag} cl_k {k}: no n > d")
                fd = (tdense.dense_rhs(dp, p + eps * v)
                      - tdense.dense_rhs(dp, p - eps * v)) / (2 * eps)
                scale = float(jv.abs().max())
                fd_err = float((jv - fd).abs().max())
                record["K25_fd"].append(dict(
                    program=f"{tag} cl_k {k}", state=which,
                    rel_err=fd_err / scale, n_above_d=above, ratios=total,
                    kink_margin=margin))
                if not fd_err <= 1e-6 * scale:
                    raise AssertionError(f"{tag} cl_k {k} ({which}): J v "
                                         f"against the central difference "
                                         f"{fd_err} of {scale}")
                extra = (f"; central difference within {fd_err / scale:.2e}"
                         f" (n > d at {above} of {total} ratios, the "
                         f"nearest kink {margin:.2e} away, eps {eps:g})")
            ties = 0
            if which == "zeroed" and not dual:
                lv = tdense.levels(p, low, a, k)
                ties = int((lv[k] == torch.repeat_interleave(lv[k - 1], a))
                           .logical_and(lv[k] > 0).sum())
            say(f"K25 {tag} cl_k {k}{' dual' if dual else ''} ({n} states, "
                f"{which}, {ties} ties at the last level): == plain bit for "
                f"bit, dy == K5's{extra}; launches K25 1, K3 {c['K3']}; "
                f"K25 and K5 the same bits in the forms "
                f"{[tdense.form_name(f) for f in tdense.forms_for(dp)]}")
            if (tag, k) in JVP_TIMED and which == "consistent" and not dual:
                time_k25(dp, p, low, v, record)
            del p, v, low, jv, plain, dy, jv2, rhs
        del dp
        torch.cuda.empty_cache()
    # The closure under torch.func.jvp (the Function's rule launches K25).
    prog = tdense.compile_dense(EX4, 5)
    fn = tdense.make_dense_dy_dt(prog, device=dev)
    p = device_spd(gen, prog.state_size, dev)
    v = torch.randn(prog.state_size, generator=gen, device=dev,
                    dtype=torch.float64) * p
    zero_deriv_counts()
    dy, jv = torch.func.jvp(fn, (p,), (v,))
    c = deriv_counts()
    if not (c["K25"] == 1 and c["K5"] == 1 and c["plain"] == 0
            and torch.equal(jv, tdense.dense_jvp_plain(fn.device_program, p,
                                                       v))
            and torch.equal(dy, fn(p))):
        raise AssertionError(f"torch.func.jvp through the closure: {c}")
    say(f"torch.func.jvp of the ex4 cl_k 5 closure: forward K3 + K5, J v by "
        f"K25 ({c}), == plain bit for bit")


def jvp_shapes(dev, record):
    """K25 and K5 at every shape phase 14 launches them (`time_jvp.SHAPES`:
    (c) ex4var2 cl_k 5, (d) ex2, ex1 and ex4var2 at cl_k 3 and ex2 at
    cl_k 6, (e) ex2's parametric rule at cl_k 4, ex4 at cl_k 5 and 8), in
    the chosen form and in the grid form: a J v call, K25 alone, K5
    alone and an RHS call, device µs by CUDA events."""
    gen = torch.Generator(device=dev).manual_seed(22)
    out = []
    for path, tag, k in time_jvp.SHAPES:
        prog = tdense.compile_dense(tag, k)
        dp = tdense.device_program(prog, dev)
        p = time_jvp.positive_state(gen, prog.size_a, k, dev)
        v = torch.randn(prog.state_size, generator=gen, device=dev,
                        dtype=torch.float64) * p
        low, vlow = tdense.pyramids(prog, p), tdense.pyramids(prog, v)
        reps = 50 if prog.state_size < 10**6 else 5
        chosen = dp.form
        row = {"path": path, "tag": tag, "cl_k": k,
               "form": tdense.form_name(chosen), "phases":
               dp.plan.num_phases, "max_phase": dp.plan.max_phase,
               "bound_ms": k25_bytes(dp) / HBM_BYTES_PER_S * 1e3}
        for form in [chosen] + ([tdense.LaunchForm(0)] if chosen.kind
                                else []):
            dp.form = form
            row[tdense.form_name(form)] = time_jvp.time_form(
                tdense, cuda, dp, p, low, v, vlow, reps, False)
        dp.form = chosen
        out.append(row)
        t = row[row["form"]]
        g = row.get("grid", t)
        say(f"step 0's shape {path} {tag} cl_k {k} ({prog.state_size} "
            f"states, {dp.plan.num_phases} phases, {row['form']}): J v call "
            f"{t['jvp_call_us']:.2f} us (grid {g['jvp_call_us']:.2f}), K25 "
            f"alone {t['k25_us']:.2f} ({g['k25_us']:.2f}), K5 alone "
            f"{t['k5_us']:.2f} ({g['k5_us']:.2f}), RHS call "
            f"{t['rhs_call_us']:.2f} ({g['rhs_call_us']:.2f}); bound "
            f"{row['bound_ms'] * 1e3:.3f} us")
        del dp, p, v, low, vlow
        torch.cuda.empty_cache()
    record["K25_shapes"] = out


def time_k25(dp, p, low, v, record):
    """K25 alone and with K3 on v, beside K5 at the same p, the bound and
    the plain version."""
    prog = dp.prog
    vlow = tdense.pyramids(prog, v)
    jdy = torch.empty_like(p)
    work = torch.empty(2 * max(dp.plan.work_size, 1), dtype=torch.float64,
                       device=p.device)
    s = torch.empty(2 * prog.num_signatures, dtype=torch.float64,
                    device=p.device)
    tdense.bare_jvp(dp, p, low, v, vlow, jdy, work, s)
    if not torch.equal(jdy, tdense.dense_jvp(dp, p, v, low)):
        raise AssertionError("K25 alone != dense_jvp")
    ms = cuda_ms(lambda: tdense.bare_jvp(dp, p, low, v, vlow, jdy, work,
                                         s), 50)
    call_ms = cuda_ms(lambda: tdense.dense_jvp(dp, p, v, low), 50)
    k5_ms = cuda_ms(lambda: tdense.sweep(dp, p, low), 50)
    rhs_ms = cuda_ms(lambda: tdense.dense_rhs(dp, p), 50)
    plain_ms = cuda_ms(lambda: tdense.dense_jvp_plain(dp, p, v, low), 2,
                       warmup=1)
    bound = k25_bytes(dp) / HBM_BYTES_PER_S * 1e3
    paced = wall_ms(lambda: tdense.dense_jvp(dp, p, v, low), 50)
    tag, k = prog.tag, prog.cl_k
    record.setdefault("K25_times", {})[k] = dict(
        ms=ms, call_ms=call_ms, k5_ms=k5_ms, rhs_ms=rhs_ms,
        plain_ms=plain_ms, bound_ms=bound, paced_ms=paced,
        bytes=k25_bytes(dp))
    say(f"K25 {tag} cl_k {k} ({tdense.form_name(dp.form)}): {ms * 1e3:.2f} us "
        f"alone ({call_ms * 1e3:.2f} us a J v call with v's levels, "
        f"{paced * 1e3:.2f} us as the host paces the call), "
        f"K5 at the same p {k5_ms * 1e3:.2f} us (the RHS {rhs_ms * 1e3:.2f} "
        f"us); bound {bound * 1e3:.3f} us ({k25_bytes(dp) / 1e6:.3f} MB at "
        f"3.35 TB/s); plain {plain_ms:.2f} ms; library: none")


# K26's shapes: (label, a, k): phase 14's (d) and (e) programs (the
# kernels line's: ex4var2 at cl_k 3), then n = 100,000 (ex4var2 at cl_k 5).
K26_SHAPES = [("(d) ex2 and ex1 cl_k 3", 2, 3), ("(d) ex2 cl_k 6", 2, 6),
              ("(d) ex4var2 cl_k 3 (support)", 10, 3),
              ("(e) ex2's parametric rule cl_k 4", 2, 4),
              ("n = 100,000", 10, 5)]


def k26_shape(dev, gen, record, label, a, k):
    """K26 at x [a^k] in every launch form it can take, both modes, the
    callers' arithmetic fused or not, against its plain version bit for
    bit (twice the same bits); then in the form `aug_form` chooses: the
    kernels a call runs (profiler), µs a call of L(x) and of the fused G
    (f - L + const) beside their byte bounds and the plain version."""
    n = a**k
    x, f, cst, ww, keep = (torch.randn(n, generator=gen, device=dev,
                                       dtype=torch.float64) for _ in range(5))
    mask = torch.rand(n, generator=gen, device=dev) < 0.7
    w = torch.linalg.qr(torch.randn(a, 2, generator=gen, device=dev,
                                    dtype=torch.float64))[0].T.contiguous()
    c_norm = float(a) ** ((k - 1) / 2.0)
    cases = [(0, {}), (0, dict(f=f, const=cst)), (0, dict(f=f)), (1, {}),
             (1, dict(f=f, const=cst, ww=ww, mask=mask, keep=keep)),
             (1, dict(f=f, ww=ww, mask=mask, keep=keep))]
    chosen = tsteady.aug_form(a, k)
    forms = tsteady.aug_forms(a, k)
    try:
        for form in forms:
            tsteady.aug_form = lambda a_, k_, f_=form: f_
            bufs = {}
            for mode, kw in cases:
                got = tsteady.steady_aug(x, a, k, w, c_norm, mode, bufs=bufs,
                                         **kw)
                again = tsteady.steady_aug(x, a, k, w, c_norm, mode,
                                           bufs=bufs, **kw)
                want = tsteady.steady_aug_plain(x, a, k, w, c_norm, mode,
                                                **kw)
                record["K26"] = max(record["K26"],
                                    float((got - want).abs().max()),
                                    float((again - want).abs().max()))
                if not (torch.equal(got, want) and torch.equal(again, want)):
                    raise AssertionError(f"K26 {label} {form} mode "
                                         f"{mode} {sorted(kw)} != plain")
    finally:
        tsteady.aug_form = AUG_FORM
    bufs = {}
    k3 = tdense.pyramid.launches
    calls, names = launch_record(lambda: tsteady.steady_aug(
        x, a, k, w, c_norm, bufs=bufs))
    if chosen == "block" and (len(calls) != 1 or
                              tdense.pyramid.launches != k3):
        raise AssertionError(f"K26 {label} ({chosen}): {calls} {names}, "
                             f"K3 {tdense.pyramid.launches - k3}")
    t = dict(label=label, n=n, form=chosen, kernels=len(calls),
             forms_checked=forms,
             ms=cuda_ms(lambda: tsteady.steady_aug(x, a, k, w, c_norm,
                                                   bufs=bufs), 100),
             fused_ms=cuda_ms(lambda: tsteady.steady_aug(
                 x, a, k, w, c_norm, f=f, const=cst, bufs=bufs), 100),
             plain_ms=cuda_ms(lambda: tsteady.steady_aug_plain(
                 x, a, k, w, c_norm), 3, warmup=1),
             bound_ms=16 * n / HBM_BYTES_PER_S * 1e3,
             fused_bound_ms=32 * n / HBM_BYTES_PER_S * 1e3)
    say(f"K26 {label} (n = {n}): == plain bit for bit in the forms "
        f"{t['forms_checked']}, both modes, fused and not; "
        f"{chosen}: {len(calls)} launch(es) a call {names}, L(x) "
        f"{t['ms'] * 1e3:.2f} us (bound {t['bound_ms'] * 1e3:.3f}), fused "
        f"G {t['fused_ms'] * 1e3:.2f} us (bound "
        f"{t['fused_bound_ms'] * 1e3:.3f}); plain {t['plain_ms']:.3f} ms")
    return t


def aug_and_kvaerno_against_plain(dev, gen, record):
    """(b) K26 at `K26_SHAPES` (`k26_shape`) and K6's third table (rows
    26-30, both swap states; the Newton and error sums; the residual)
    against their plain versions bit for bit at ex4var2 cl_k 5's size,
    twice the same bits,
    the largest error of each recorded; each timed beside its bound and
    plain version, and stage g4 beside `torch.addmv`."""
    n = 10**KV_CL_K
    out = torch.empty(n, dtype=torch.float64, device=dev)
    record["K26"] = 0.0
    record["K26_shapes"] = [k26_shape(dev, gen, record, *sh)
                            for sh in K26_SHAPES]
    # The kernels line's: (d)'s most launched program, ex4var2 cl_k 3.
    record["K26_times"] = record["K26_shapes"][2]
    y, y_new, dz, f, g = (torch.randn(n, generator=gen, device=dev,
                                      dtype=torch.float64) for _ in range(5))
    ks = dop853.rows_tensor(4, n, dev)
    ks.copy_(torch.randn((4, n), generator=gen, device=dev,
                         dtype=torch.float64))
    out2 = torch.empty_like(y)

    def diff(x, y):
        return float((x - y).abs().max())

    err6 = 0.0
    for which in (26, 27, 28, 29, 30):
        for swap in (0, 1):
            dop853.stage(y, ks, 0.37, which, out, swap, 3)
            dop853.stage_plain(y, ks, 0.37, dop853.tableau_terms(
                which, swap, 3), out2)
            err6 = max(err6, diff(out, out2))
            if not torch.equal(out, out2):
                raise AssertionError(f"K6 row {which} swap {swap} != plain")
    rtol, atol = 1e-8, 1e-10
    for mode, kw in ((dop853._NEWTON, dict(f0=dz)),
                     (dop853._ERR_DIFF, dict(y_new=y_new, f0=dz))):
        z1, z2 = g.clone(), g.clone()
        got = dop853.norms(mode, y, rtol, atol, f1=z1, **kw).clone()
        want = dop853.norms_plain(mode, y, rtol, atol, f1=z2, **kw)
        err6 = max(err6, diff(got, want), diff(z1, z2))
        if not (torch.equal(got, want) and torch.equal(z1, z2)):
            raise AssertionError(f"K6 norms mode {mode} != plain")
    dop853.resid(y, g, f, 0.25, out)
    want = dop853.resid_plain(y, g, f, 0.25, out2)
    err6 = max(err6, diff(out, want))
    if not torch.equal(out, want):
        raise AssertionError("K6 resid != plain")
    record["K6_kv"] = err6
    # Stage g4 as one library call: y + h (a41 k1 + a42 k2 + a43 k3).
    coef = torch.tensor([c for _, c in dop853.TABLEAU[28]],
                        dtype=torch.float64, device=dev)
    lib_g4 = torch.addmv(y, ks[:3].T, coef, alpha=0.37)
    dop853.stage(y, ks, 0.37, 28, out)
    if not torch.allclose(lib_g4, out, rtol=RHS_RTOL, atol=RHS_ATOL):
        raise AssertionError("torch.addmv yardstick != Kvaerno's stage g4")
    scratch6 = dop853.norm_scratch(dev)
    zc = g.clone()
    # (kernel, vectors moved, plain version, one library call or None).
    # No single call forms the Newton sum fused with z += dz, the scaled
    # error sum or the residual z - h gamma f - g: each takes a
    # quotient or a subtraction before its reduction or a second call.
    times = {
        "stage g4 (row 28)": (lambda: dop853.stage(y, ks, 0.37, 28, out), 5,
                              lambda: dop853.stage_plain(
                                  y, ks, 0.37, dop853.tableau_terms(28),
                                  out2),
                              lambda: torch.addmv(y, ks[:3].T, coef,
                                                  alpha=0.37)),
        "Newton sum + update": (lambda: dop853.norms(
            dop853._NEWTON, y, rtol, atol, f0=dz, f1=zc, scratch=scratch6),
            4, lambda: dop853.norms_plain(dop853._NEWTON, y, rtol, atol,
                                          f0=dz, f1=zc), None),
        "embedded error sum": (lambda: dop853.norms(
            dop853._ERR_DIFF, y, rtol, atol, y_new=y_new, f0=dz,
            scratch=scratch6), 3, lambda: dop853.norms_plain(
                dop853._ERR_DIFF, y, rtol, atol, y_new=y_new, f0=dz), None),
        "residual": (lambda: dop853.resid(y, g, f, 0.25, out), 4,
                     lambda: dop853.resid_plain(y, g, f, 0.25, out2), None),
    }
    record["K6_times"] = {}
    for name, (fn, vecs, plain, library) in times.items():
        t = dict(ms=cuda_ms(fn, 200), plain_ms=cuda_ms(plain, 5),
                 bound_ms=8 * vecs * n / HBM_BYTES_PER_S * 1e3,
                 library_ms=None if library is None
                 else cuda_ms(library, 200))
        record["K6_times"][name] = t
        lib_say = ("none" if library is None
                   else f"torch.addmv {t['library_ms'] * 1e3:.2f} us")
        say(f"K6 Kvaerno {name} (n = {n}): == plain bit for bit; "
            f"{t['ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({vecs} vectors), plain {t['plain_ms'] * 1e3:.2f} us; "
            f"library {lib_say}")


def _rob(y, t):
    d1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    d3 = 3e7 * y[1] * y[1]
    return torch.stack([d1, -d1 - d3, d3])


def stiff_runs(dev, record):
    """(c) kvaerno3 on ex4var2 at cl_k 5 through `solve` against the port's
    DOP853 (`tests/test_ode.py:326`'s bounds), K25 launched once a J v
    of the solver's count and no plain version called; Robertson against
    scipy's Radau (`tests/test_ode.py:290`)."""
    import scipy.integrate

    prog = tdense.compile_dense(EX4V2, KV_CL_K)
    fn = tdense.make_dense_dy_dt(prog, device=dev)
    p0 = chemical_turing_v2_p0(KV_CL_K).ravel()
    zero_deriv_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys, info = solve(lambda y, t: fn(y), p0, KV_TS, rtol=1e-8, atol=1e-10,
                     method="kvaerno3", device=dev, return_info=True)
    seconds = time.perf_counter() - t0
    c = deriv_counts()
    if c["K25"] != info["num_jvp"] or c["plain"] or not c["K6"]:
        raise AssertionError(f"kvaerno3: launches {c}, J v {info}")
    ref = solve(lambda y, t: fn(y), p0, KV_TS, rtol=1e-10, atol=1e-12,
                device=dev)
    err = float(np.max(np.abs(ys - ref) / (1e-9 + 2e-6 * np.abs(ref))))
    np.testing.assert_allclose(ys, ref, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(ys.sum(axis=1), 1.0, rtol=1e-7)
    steps = info["num_accepted"] + info["num_rejected"]
    routes = dual_routes(fn, p0, ys, dev)
    record["kvaerno"] = dict(info=info, seconds=seconds, launches=c,
                             ms_per_step=seconds * 1e3 / steps,
                             dual_routes=routes)
    say(f"kvaerno3 ex4var2 cl_k {KV_CL_K} ({prog.state_size} states) to t="
        f"{KV_TS[-1]:g}: {info['num_accepted']} accepted, "
        f"{info['num_rejected']} rejected, {info['num_newton']} Newton "
        f"iterations, {info['num_jvp']} J v (K25 {c['K25']}, K3 {c['K3']}, "
        f"K5 {c['K5']}, K6 {c['K6']}, plain 0) in {seconds:.2f} s "
        f"({seconds * 1e3 / steps:.1f} ms a step); against DOP853 at "
        f"1e-10/1e-12 within {err:.3f} of rtol 2e-6 + atol 1e-9")
    ts = np.array([0.0, 1e-2, 1.0, 1e2, 1e4])
    y0 = np.array([1.0, 0.0, 0.0])
    t0 = time.perf_counter()
    yr, rinfo = odeint_kvaerno3(_rob, torch.as_tensor(y0, device=dev), ts,
                                (1e-8, 1e-10))
    rs = time.perf_counter() - t0
    want = scipy.integrate.solve_ivp(
        lambda t, y: _rob(torch.as_tensor(y), t).numpy(), (0, 1e4), y0,
        t_eval=ts, rtol=1e-10, atol=1e-12, method="Radau").y.T
    if not (rinfo.completed and rinfo.num_accepted < 10_000):
        raise AssertionError(f"Robertson: {rinfo}")
    np.testing.assert_allclose(yr.cpu().numpy()[1:], want[1:], rtol=1e-6,
                               atol=1e-12)
    say(f"Robertson on the card: {rinfo.num_accepted} accepted, "
        f"{rinfo.num_rejected} rejected, {rinfo.num_jvp} J v in {rs:.2f} s; "
        f"== scipy Radau within rtol 1e-6, atol 1e-12")


def dual_routes(fn, p0, ys, dev):
    """The same kvaerno3 solve with the solvers' forward-AD duals answered
    two ways: by one K25 launch that returns dp/dt and J v
    (`dense.rhs_fn`'s shortcut), and through `dense.RHSFunction` (K3 and
    K5 forward, then K3 on v and K25), in the order shortcut, Function,
    Function, shortcut. Both give the solve's bits; ms a step on the
    host's clock, the card drained at the end of each."""
    out = {"shortcut": [], "function": []}
    shortcut = tdense.forward_dual
    for route in ("shortcut", "function", "function", "shortcut"):
        tdense.forward_dual = (shortcut if route == "shortcut"
                               else lambda p: None)
        try:
            zero_deriv_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, info = solve(lambda y, t: fn(y), p0, KV_TS, rtol=1e-8,
                              atol=1e-10, method="kvaerno3", device=dev,
                              return_info=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            tdense.forward_dual = shortcut
        c = deriv_counts()
        if not np.array_equal(got, ys) or c["plain"]:
            raise AssertionError(f"kvaerno3 by the {route} route differs: "
                                 f"{c}")
        steps = info["num_accepted"] + info["num_rejected"]
        out[route].append(dict(ms_per_step=ms / steps, K25=c["K25"],
                               K5=c["K5"], K3=c["K3"]))
    a = [r["ms_per_step"] for r in out["shortcut"]]
    b = [r["ms_per_step"] for r in out["function"]]
    say(f"kvaerno3's J v by route, ms a step (shortcut, Function, Function, "
        f"shortcut): {a[0]:.2f}, {b[0]:.2f}, {b[1]:.2f}, {a[1]:.2f}; "
        f"launches a solve: shortcut K25 {out['shortcut'][0]['K25']}, K5 "
        f"{out['shortcut'][0]['K5']}; Function K25 "
        f"{out['function'][0]['K25']}, K5 {out['function'][0]['K5']}; the "
        f"same bits")
    return out


def steady_checks(label, info, c, extra=""):
    """K25 once a J_G v, K26 once a J_G v and a G, no plain version."""
    if (c["K25"] != info.matvecs or c["K26"] != info.matvecs + info.residuals
            or c["plain"]):
        raise AssertionError(f"{label}: launches {c}, {info}")
    say(f"{label}: {info.iterations} PTC iterations, residual "
        f"{info.residual:.3e}, {info.matvecs} J_G v (K25 {c['K25']}), "
        f"{info.residuals} G (K26 {c['K26']} = J_G v + G){extra}")


def steady_runs(dev, record):
    """(d) the steady states of `tests/test_steady.py` through the card's
    RHS, Gibbs from the port's `ising_gibbs_windows`."""
    k = KV_STEADY["ex2"]
    gibbs = ferromagnet.ising_gibbs_windows(k, J_eff=2.0, h=-0.25, beta=1.0)
    zero_deriv_counts()
    p_inf, info = tsteady.steady_state(EX2, k, np.full(2**k, 2.0**-k),
                                       warm_t=5.0, device=dev)
    c = deriv_counts()
    err = float(np.abs(p_inf.cpu().numpy() - gibbs).max())
    if not (info.converged and info.residual <= 1e-12 and err <= 1e-9):
        raise AssertionError(f"ex2 cl_k {k}: {info}, Gibbs {err}")
    steady_checks(f"ex2 cl_k {k} from uniform", info, c,
                  f"; Gibbs within {err:.2e}")
    record["steady"] = [(f"ex2 cl_k {k}", info, c)]
    zero_deriv_counts()
    p_inf, info = tsteady.steady_state("ex1-radioactive-decay", k,
                                       np.full(2**k, 2.0**-k), warm_t=10.0,
                                       device=dev)
    c = deriv_counts()
    if not (info.converged and abs(float(p_inf[0]) - 1) <= 1e-10
            and float(p_inf[1:].abs().max()) < 1e-10):
        raise AssertionError(f"ex1's corner: {info}")
    steady_checks(f"ex1 cl_k {k} corner", info, c)
    record["steady"].append((f"ex1 cl_k {k}", info, c))
    k4 = KV_STEADY["ex4v2"]
    fn, _ = tengine.build_dy_dt(EX4V2, k4, device=dev)
    p0 = torch.as_tensor(chemical_turing_v2_p0(k4).ravel(), device=dev)
    pw = torch.clamp(odeint_fixed(lambda y, t: fn(y), p0, [0.0, 1e3],
                                  n_sub=200)[-1], min=0.0)
    zero_deriv_counts()
    solve_s = tsteady.make_steady_state(
        lambda p, a: fn(p), size_a=10, cl_k=k4, conserved="support",
        support_guess=pw.cpu().numpy(), delta0=1e12, max_iter=150,
        gmres_restart=60, gmres_maxiter=4, device=dev)
    p_inf, info = solve_s(pw, None)
    c = deriv_counts()
    dead = pw <= 1e-20
    if not (info.residual < 5e-8 and float(p_inf[dead].abs().max()) == 0.0
            and abs(float(p_inf.sum()) - 1) < 1e-6):
        raise AssertionError(f"ex4var2 support mode: {info}")
    steady_checks(f"ex4var2 cl_k {k4} support mode", info, c,
                  f"; {int(dead.sum())} dead windows exactly 0")
    record["steady"].append((f"ex4var2 cl_k {k4} support", info, c))
    fn2, _ = tengine.build_dy_dt(EX2, k, device=dev)
    zero_deriv_counts()
    lams, resids = tsteady.relaxation_modes(
        lambda p, a: fn2(p), torch.as_tensor(gibbs, device=dev), size_a=2,
        cl_k=k, n_modes=4, krylov_m=8, device=dev)
    tau = -1.0 / np.real(lams[0])
    if not (np.all(resids < 1e-8) and np.all(np.real(lams) < 0)
            and 50 < tau < 5000):
        raise AssertionError(f"relaxation modes {lams} {resids}")
    say(f"relaxation modes ex2 cl_k {k}: lambda {np.round(lams, 6)}, "
        f"residuals < {resids.max():.1e}, tau {tau:.1f}; "
        f"K25 {deriv_counts()['K25']}, K26 {deriv_counts()['K26']}")
    kw = KV_STEADY["ex2_wide"]
    gw = ferromagnet.ising_gibbs_windows(kw, J_eff=2.0, h=-0.25, beta=1.0)
    zero_deriv_counts()
    t0 = time.perf_counter()
    p_inf, info = tsteady.steady_state(EX2, kw, np.full(2**kw, 2.0**-kw),
                                       warm_t=5.0, device=dev)
    seconds = time.perf_counter() - t0
    c = deriv_counts()
    err = float(np.abs(p_inf.cpu().numpy() - gw).max())
    if not (info.converged and err <= 2e-9):
        raise AssertionError(f"ex2 cl_k {kw}: {info}, Gibbs {err}")
    steady_checks(f"ex2 cl_k {kw} from uniform", info, c,
                  f"; Gibbs within {err:.2e}; {seconds:.2f} s")
    record["steady"].append((f"ex2 cl_k {kw}", info, c))


def analytic_ising(beta, j_eff=2.0, h=-0.25):
    """`examples/ex2_correlations.py:analytic_ising`: (m, amp, ratio) with
    C(d) = amp ratio^d for the 2 x 2 transfer matrix."""
    s = np.array([-1.0, 1.0])
    T = np.exp(beta * (j_eff * np.outer(s, s)
                       + 0.5 * h * (s[:, None] + s[None, :])))
    lam, u = np.linalg.eigh(T)
    order = np.argsort(lam)[::-1]
    lam, u = lam[order], u[:, order]
    m = float(u[:, 0] @ (s * u[:, 0]))
    amp = float(u[:, 0] @ (s * u[:, 1])) ** 2
    return m, amp, lam[1] / lam[0]


def correlations_example(dev, record):
    """(e) `examples/ex2_correlations.py`'s continuation through the port
    on the card: every solve converges, the 11 SPDs within 1e-9 of the
    committed npz, the correlator on the analytic Ising curve within
    1e-6 out to d = 30 (the example's own gate)."""
    from chemical_kinetics_and_program_execution_torch.ops import (
        correlations as tcorr,
    )

    pd = tparam.ParametricDense("ex2-ferromagnetic-chain-p", CORR_CL_K,
                                device=dev)
    defaults = pd.problem.param_defaults
    solve_c = tsteady.make_steady_state(
        lambda p, w: pd.dy_dt(p, w), size_a=2, cl_k=CORR_CL_K, tol=1e-13,
        probe_args=pd.consts(defaults), device=dev)
    zero_deriv_counts()
    t0 = time.perf_counter()
    spds, guess, its = [], torch.full((2**CORR_CL_K,), 2.0**-CORR_CL_K,
                                      dtype=torch.float64, device=dev), []
    matvecs = residuals = 0
    for beta in CORR_BETAS:
        prm = dict(defaults)
        prm["beta"] = float(beta)
        p_inf, info = solve_c(guess, pd.consts(prm))
        if not info.converged:
            raise AssertionError(f"no convergence at beta={beta:g}")
        spds.append(p_inf.cpu().numpy())
        its.append(info.iterations)
        matvecs += info.matvecs
        residuals += info.residuals
        guess = p_inf
    seconds = time.perf_counter() - t0
    c = deriv_counts()
    if (c["K25"] != matvecs or c["K26"] != matvecs + residuals
            or c["plain"]):
        raise AssertionError(f"ex2_correlations: launches {c}")
    spds = np.stack(spds)
    want = np.load(EXAMPLES / "ex2_correlations.npz")["spds"]
    err = float(np.abs(spds - want).max())
    if not err <= 1e-9:
        raise AssertionError(f"ex2_correlations: {err} from the npz")
    spin = {(0,): -1.0, (1,): 1.0}
    worst = 0.0
    for beta in CORR_DETAIL:
        bi = int(np.argmin(np.abs(CORR_BETAS - beta)))
        got = tcorr.observable_correlation(
            spds[bi].reshape((2,) * CORR_CL_K), spin, spin, CORR_DS)
        _, amp, ratio = analytic_ising(CORR_BETAS[bi])
        worst = max(worst, float(np.max(np.abs(
            got - amp * ratio ** CORR_DS.astype(float)))))
    if not worst < 1e-6:
        raise AssertionError(f"correlator off the analytic curve: {worst}")
    record["correlations"] = dict(seconds=seconds, launches=c, its=its)
    say(f"ex2_correlations through the port: 11 betas in {seconds:.2f} s "
        f"(PTC iterations {its}), K25 {c['K25']}, K26 {c['K26']}; SPDs "
        f"within {err:.2e} of examples/ex2_correlations.npz; correlator "
        f"within {worst:.2e} of the analytic curve out to d = 30")


def deriv_phase(dev, kernels):
    """Phase 14: (a)-(e) above, and the `kernels` line's K25, K26 and K6
    Kvaerno entries."""
    gen = torch.Generator(device=dev).manual_seed(14)
    record = {"K25": 0.0}
    jvp_against_plain(dev, gen, record)
    jvp_shapes(dev, record)
    aug_and_kvaerno_against_plain(dev, gen, record)
    stiff_runs(dev, record)
    steady_runs(dev, record)
    correlations_example(dev, record)
    times25 = record["K25_times"]
    t25 = times25[JVP_TIMED[0][1]]
    t26, kv = record["K26_times"], record["kvaerno"]
    steady = {label: {"iterations": info.iterations,
                      "residual": info.residual, "matvecs": info.matvecs,
                      "residuals": info.residuals, "K25": c["K25"],
                      "K26": c["K26"]}
              for label, info, c in record["steady"]}
    kernels["K25"] = {
        "name": K25[0], "route": "cuda", "source": K25[1],
        "replaces": K25[2], "launches": kv["launches"]["K25"],
        "max_abs_err": record["K25"],
        "match": "bit-identical to dense_jvp_plain on every JVP_CASES "
                 "program at a positive and a zeroed p",
        "ms": t25["ms"], "plain_ms": t25["plain_ms"],
        "bound_ms": t25["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "with_k3_on_v_ms": t25["call_ms"],
        "k5_same_p_ms": t25["k5_ms"], "rhs_same_p_ms": t25["rhs_ms"],
        "paced_ms": t25["paced_ms"], "steady": steady,
        "central_difference": record["K25_fd"],
        "by_cl_k": {str(k): t for k, t in times25.items()},
        "form": record["K25_shapes"][-2]["form"],
        "by_shape": record["K25_shapes"],
        "correlations": record["correlations"]["launches"]["K25"]}
    kernels["K26"] = {
        "name": K26[0], "route": "cuda", "source": K26[1],
        "replaces": K26[2],
        "launches": sum(v["K26"] for v in steady.values())
        + record["correlations"]["launches"]["K26"],
        "max_abs_err": record["K26"],
        "match": "bit-identical in every launch form, both modes, the "
                 "callers' arithmetic fused and not",
        "ms": t26["ms"], "plain_ms": t26["plain_ms"],
        "bound_ms": t26["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "form": t26["form"],
        "by_shape": record["K26_shapes"]}
    k6 = record["K6_times"]
    kernels["K6_kvaerno"] = {
        "name": K6_KV[0], "route": "cuda", "source": K6_KV[1],
        "replaces": K6_KV[2], "launches": kv["launches"]["K6"],
        "max_abs_err": record["K6_kv"],
        "match": "bit-identical: rows 26-30, both swaps; Newton and error "
                 "sums; residual",
        "ms": k6["Newton sum + update"]["ms"],
        "plain_ms": k6["Newton sum + update"]["plain_ms"],
        "bound_ms": k6["Newton sum + update"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "entries": k6,
        "kvaerno3": {"accepted": kv["info"]["num_accepted"],
                     "rejected": kv["info"]["num_rejected"],
                     "newton": kv["info"]["num_newton"],
                     "jvp": kv["info"]["num_jvp"],
                     "seconds": kv["seconds"],
                     "ms_per_step": kv["ms_per_step"],
                     "dual_routes": kv["dual_routes"]}}


# --- Phase 15: the companion simulators (K27-K29) -----------------------------

FP64_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores (data sheet)
FP32_FLOPS = 67e12  # float32 outside the tensor cores (data sheet)
SSA_NET = (1.0, 100.0, 1.0, 1.0, 100.0, 1.0, 10.0, 2.0)  # bench.py:274-276
SSA_N0 = (0, 0, 2000)
SSA_B, SSA_E = 65536, 1000  # bench_ssa's CKPE_BENCH_SSA_B and _E defaults
SSA_CHECK_E, SSA_REF_T = 50, 512
# examples/ex2_ferromagnet_mc.py:19-42 (rounds_per_step 20 by default).
MC = dict(num_trials=100, chain_length=50_000, num_steps=4000,
          trials_per_step=500, sites_per_pair=250, J=1.0, h=-0.25, beta=1.0,
          rounds_per_step=20, seed=1000)
MC_CHECK_STEPS, MC_BLOCKS, MC_T_MAX = 20, 10, 40.0
AC_TS = np.linspace(0.0, 100.0, 10001)  # examples/autocatalysis.py:44
AC_CHECK = 1001
AC_RHS_FLOPS = 44  # csrc/dopri5_rule.cuh:ac_rhs, counted
COMP_BUDGET_S = 90.0
COMP_WRAPPERS = {"K27": gillespie.ssa_round, "K28": ferromagnet.metropolis,
                 "K29": autocatalysis.dopri5_batch}
COMP_PLAIN = [gillespie.ssa_round_plain, ferromagnet.metropolis_plain,
              autocatalysis._solve_batch_plain]
K27 = ("K27 ssa_round", SRC + "ssa_round.cu",
       "the JAX package's models/gillespie.py:152 ssa_batch_tm (its "
       "lax.scan body :194-226; XLA), wrapped by :239 ssa_batch and :250 "
       "run_ssa_ensemble")
K28 = ("K28 metropolis", SRC + "metropolis.cu",
       "the JAX package's models/ferromagnet.py:95 simulate_metropolis "
       "(do_round :111-126, island_counts :128-142; XLA), vmapped by :166 "
       "mc_island_history")
K29 = ("K29 dopri5_batch", SRC + "dopri5_batch.cu",
       "the JAX package's models/autocatalysis.py:57 _solve_batch (vmap of "
       "ode/dopri5.py:48 odeint_dopri5 over :29 dy_dt; XLA)")


def comp_path(label, fn, need):
    """``fn()`` with every count of phase 15 set to 0 just before and read
    just after (a plain version called raises); returns (its result, the
    launches, host seconds to the card's end)."""
    for w in COMP_WRAPPERS.values():
        w.launches = 0
    for p in COMP_PLAIN:
        p.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in COMP_WRAPPERS.items()}
    plain = sum(p.calls for p in COMP_PLAIN)
    say(f"{label}: {seconds:.4f} s, launches {launches}, plain calls {plain}")
    if plain:
        raise AssertionError(f"{label}: a plain version ran on the path")
    need_launches(label, launches, need)
    return out, launches, seconds


def once_ms(fn):
    """Milliseconds of one call of ``fn`` by CUDA events (host pacing
    included: for the plain versions, thousands of small launches)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def ssa_flops_per_event(net):
    """Float operations of one K27 event: a subtraction, a max and a
    product a falling-factorial factor, the total and running sums, a
    compare a reaction, log1p, the quotient and u1 * total."""
    R = net.reactants.shape[0]
    return 3 * int(net.reactants.sum()) + 3 * R + 4


def k29_flops_per_step():
    """Float64 operations of one K29 step: six rate-law evaluations, the
    stage inputs (a product a term, the sums, h times and y plus), y_new,
    the error (quotient, scale, norm) and the controller's three
    powers."""
    rows = autocatalysis.tableau_rows()
    stage = sum(3 * (2 * len(t) + 1) for t in rows[:7])
    err = 3 * (2 * len(rows[7]) + 1) + 3 * 2 + 7
    return 6 * AC_RHS_FLOPS + stage + err + 9


def ssa_part(dev, record):
    """(a): the SSA at bench_ssa's geometry, K27 against plain, moments."""
    net = gillespie.autocatalysis_network(*SSA_NET)
    gen = torch.Generator(device=dev).manual_seed(15)
    gillespie.ssa_batch_tm(gen, SSA_N0, net, 4, 64, device=dev)  # warm
    runs = {}
    for label in ("first call", "warm call"):
        (ts, ns), c, secs = comp_path(
            f"(a) SSA float32 B={SSA_B} E={SSA_E}, {label}",
            lambda: gillespie.ssa_batch_tm(gen, SSA_N0, net, SSA_E, SSA_B,
                                           device=dev), ["K27"])
        runs[label] = secs
    if (ts.shape != (SSA_E, SSA_B) or ns.shape != (SSA_E, 3, SSA_B)
            or ts.dtype != torch.float64 or ns.dtype != torch.int32):
        raise AssertionError("SSA outputs' shapes or types")
    if not (bool(torch.isfinite(ts).all()) and bool((ts[1:] >= ts[:-1]).all())
            and int(ns.min()) >= 0 and bool((ts[0] > 0).all())):
        raise AssertionError("SSA times not finite and increasing, or a "
                             "count below 0")
    secs = runs["warm call"]
    say(f"(a) SSA: {SSA_B / secs:.6e} trajectories/s, "
        f"{SSA_B * SSA_E / secs:.6e} events/s (warm, draws included); "
        f"first call {runs['first call']:.4f} s")
    final32 = ns[-1].T.double().cpu().numpy()
    del ts, ns
    # K27 against its plain version on the same draws, bit for bit.
    err = 0.0
    for dtype in (torch.float32, torch.float64):
        u = torch.rand((SSA_CHECK_E, 2, SSA_B), generator=gen, dtype=dtype,
                       device=dev)
        outs = []
        for fn in (gillespie.ssa_round, gillespie.ssa_round_plain):
            t = torch.zeros(SSA_B, dtype=torch.float64, device=dev)
            n = torch.as_tensor(SSA_N0, dtype=torch.int32, device=dev)
            n = n[:, None].expand(3, SSA_B).contiguous()
            t_o = torch.empty((SSA_CHECK_E, SSA_B), dtype=torch.float64,
                              device=dev)
            n_o = torch.empty((SSA_CHECK_E, 3, SSA_B), dtype=torch.int32,
                              device=dev)
            fn(net, u, t, n, t_o, n_o)
            outs.append((t_o, n_o))
        torch.cuda.synchronize()
        (tk, nk), (tp, np_) = outs
        err = max(err, float((tk - tp).abs().max()),
                  float((nk - np_).abs().max()))
        if not (torch.equal(tk, tp) and torch.equal(nk, np_)):
            raise AssertionError(f"K27 != plain ({dtype})")
        say(f"(a) K27 == plain bit for bit, {dtype}, B={SSA_B}, "
            f"{SSA_CHECK_E} events")
    # K27's wide form (the network in global memory) past each limit.
    for kind in ("reactions", "species", "factors"):
        wnet, wn0 = ssa_past_limits(kind)
        S = len(wn0)
        for dtype in (torch.float32, torch.float64):
            u = torch.rand((SSA_CHECK_E, 2, SSA_B), generator=gen,
                           dtype=dtype, device=dev)
            outs = []
            for fn in (gillespie.ssa_round, gillespie.ssa_round_plain):
                t = torch.zeros(SSA_B, dtype=torch.float64, device=dev)
                n = torch.as_tensor(wn0, dtype=torch.int32, device=dev)
                n = n[:, None].expand(S, SSA_B).contiguous()
                t_o = torch.empty((SSA_CHECK_E, SSA_B), dtype=torch.float64,
                                  device=dev)
                n_o = torch.empty((SSA_CHECK_E, S, SSA_B), dtype=torch.int32,
                                  device=dev)
                fn(wnet, u, t, n, t_o, n_o)
                outs.append((t_o, n_o))
            torch.cuda.synchronize()
            (tk, nk), (tp, np_) = outs
            err = max(err, float((tk - tp).abs().max()),
                      float((nk - np_).abs().max()))
            moved = int((np_[-1] != np_[0]).sum())
            if not (torch.equal(tk, tp) and torch.equal(nk, np_) and moved):
                raise AssertionError(f"K27's wide form != plain ({kind}, "
                                     f"{dtype}, {moved} counts moved)")
        say(f"(a) K27's wide form == plain bit for bit past the {kind} "
            f"limit ({wnet.reactants.shape[0]} reactions, {S} species, "
            f"{int(wnet.reactants.sum(axis=1).max())} factors at most), "
            f"float32 and float64, B={SSA_B}, {SSA_CHECK_E} events")
    # The moment gates of tests/test_models.py:189 at full B.
    (_, ns64), _, _ = comp_path(
        "(a) SSA float64 core", lambda: gillespie.ssa_batch_tm(
            gen, SSA_N0, net, SSA_E, SSA_B, torch.float64, device=dev),
        ["K27"])
    final64 = ns64[-1].T.double().cpu().numpy()
    del ns64
    _, ref = gillespie.ssa_trajectories(gen, SSA_N0, net, SSA_E, SSA_REF_T,
                                        device=dev)
    final_ref = ref[:, -1].double().cpu().numpy()
    zmax = 0.0
    for name, b in (("float64 core", final64),
                    ("ssa_trajectories", final_ref)):
        se = np.sqrt(final32.var(axis=0) / len(final32)
                     + b.var(axis=0) / len(b))
        diff = np.abs(final32.mean(axis=0) - b.mean(axis=0))
        z = diff / np.maximum(se, 1e-300)
        zmax = max(zmax, float(z.max()))
        if not (diff <= 5 * se + 1e-9).all():
            raise AssertionError(f"SSA means: float32 vs {name}: z {z}")
        say(f"(a) float32 vs {name}: mean z by species {np.round(z, 3)}")
    ratio = final32.var(axis=0) / np.maximum(final64.var(axis=0), 1e-9)
    if not ((ratio > 0.7) & (ratio < 1.4)).all():
        raise AssertionError(f"SSA variance ratio {ratio}")
    say(f"(a) largest z {zmax:.4f}; variance ratio float32 / float64 "
        f"{np.round(ratio, 4)}")
    # K27 alone at the main path's launch (one chunk of events).
    chunk = gillespie.DRAW_CHUNK // (2 * SSA_B)
    u = torch.rand((chunk, 2, SSA_B), generator=gen, device=dev)
    t = torch.zeros(SSA_B, dtype=torch.float64, device=dev)
    n = torch.as_tensor(SSA_N0, dtype=torch.int32, device=dev)
    n = n[:, None].expand(3, SSA_B).contiguous()
    t_o = torch.empty((chunk, SSA_B), dtype=torch.float64, device=dev)
    n_o = torch.empty((chunk, 3, SSA_B), dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: gillespie.ssa_round(net, u, t, n, t_o, n_o), 5)
    plain_ms = once_ms(lambda: gillespie.ssa_round_plain(net, u, t, n, t_o,
                                                         n_o))
    nbytes_ = (u.numel() * 4 + t_o.numel() * 8 + n_o.numel() * 4
               + 2 * (t.numel() * 8 + n.numel() * 4))
    bytes_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ssa_flops_per_event(net) * chunk * SSA_B / FP32_FLOPS * 1e3
    say(f"(a) K27 alone, {chunk} events x {SSA_B}: {ms:.4f} ms against a "
        f"bound of {max(bytes_ms, ops_ms):.4f} ms ({nbytes_ / 1e6:.1f} MB; "
        f"operations {ops_ms:.4f} ms); plain {plain_ms:.2f} ms")
    record["K27"] = {
        "name": K27[0], "route": "cuda", "source": K27[1], "replaces": K27[2],
        "launches": c["K27"], "max_abs_err": err,
        "match": f"bit-identical to ssa_round_plain, float32 and float64, "
                 f"B={SSA_B}, {SSA_CHECK_E} events; the wide form too, "
                 "past each shared-memory limit",
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "events_per_launch": chunk,
        "trajectories_per_s": SSA_B / secs,
        "events_per_s": SSA_B * SSA_E / secs,
        "first_call_s": runs["first call"], "warm_call_s": secs,
        "largest_z": zmax, "variance_ratio": ratio.tolist()}


def ssa_past_limits(kind):
    """A network past one of K27's shared-memory limits (33 reactions, 9
    species, 9 factors a reaction), with its start counts; the networks
    of tests/test_torch_gillespie.py and tests/test_torch_gpu.py."""
    rng = np.random.RandomState({"reactions": 1, "species": 2,
                                 "factors": 3}[kind])
    R, S = {"reactions": (33, 3), "species": (12, 9),
            "factors": (5, 2)}[kind]
    reactants = rng.randint(0, 2, (R, S))
    if S > 8:
        reactants[:, 8] = 0
        reactants[0] = 0
        reactants[0, 8] = 1
    if kind == "factors":
        reactants[1] = 0
        reactants[1, 0] = 9
    products = rng.randint(0, 3, (R, S))
    rates = rng.uniform(0.2, 1.0, R) * 20.0 ** -reactants.sum(axis=1)
    return (gillespie.ReactionNetwork(reactants, products, rates),
            tuple([25] * S))


# K28 on long chains (87,008 bytes of shared memory a block).
MC_LONG = dict(T=4, N=300_000, rounds=20, rs=25, steps=8)
# K28's other forms, each against its plain version: 40 trials a round
# (two round warps) on a ring whose last word is partial, one trial a
# round, a ring below 64 sites (the count a site), a full warp of trials.
MC_SHAPES = [dict(T=8, N=4_097, rounds=8, rs=40, steps=20),
             dict(T=8, N=1_001, rounds=24, rs=1, steps=20),
             dict(T=4, N=50, rounds=20, rs=25, steps=20),
             dict(T=4, N=64, rounds=20, rs=32, steps=20)]


def mc_block_z(counts, ref):
    """The largest z over L = 1..4 and ten 400-step blocks: the trial
    mean of each block average of ``counts`` against ``ref``'s, in
    combined standard errors."""
    zmax = 0.0
    width = counts.shape[1] // MC_BLOCKS
    for L in range(1, 5):
        for k in range(MC_BLOCKS):
            a = counts[:, k * width:(k + 1) * width, L].mean(axis=1)
            b = ref[:, k * width:(k + 1) * width, L].mean(axis=1)
            se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
            zmax = max(zmax, abs(a.mean() - b.mean()) / max(se, 1e-300))
    return zmax


def mc_part(dev, record):
    """(b): the Metropolis chains at the example's geometry."""
    T, N = MC["num_trials"], MC["chain_length"]
    rounds = MC["rounds_per_step"]
    rs = MC["trials_per_step"] // rounds
    gen = torch.Generator(device=dev).manual_seed(MC["seed"])
    ferromagnet.mc_island_history(num_trials=2, chain_length=64, num_steps=3,
                                  trials_per_step=4, generator=gen,
                                  rounds_per_step=2, device=dev)  # warm
    kw = {k: v for k, v in MC.items() if k != "seed"}
    counts, c, secs = comp_path(
        f"(b) Metropolis {T} x {N} x {MC['num_steps']} steps",
        lambda: ferromagnet.mc_island_history(generator=gen, device=dev,
                                              **kw), ["K28"])
    if counts.shape != (T, MC["num_steps"], 6) or (counts[..., 0] != 0).any():
        raise AssertionError("Metropolis counts' shape or column 0")
    if counts.min() < 0 or counts[:, 0, 2].sum() == 0:
        raise AssertionError("Metropolis counts below 0, or no start pairs")
    steps = MC["num_steps"] - 1
    say(f"(b) Metropolis: {steps / secs:.4f} steps/s of the ensemble, "
        f"{steps * T / secs:.6e} chain-steps/s, "
        f"{steps * T * rs * rounds / secs:.6e} trials/s (draws included)")
    ref = np.load(EXAMPLES / "ferromagnet_mc_chain_counts.npz")[
        "chain_counts"]
    zmax = mc_block_z(counts, ref)
    if not zmax < 5:
        raise AssertionError(f"Metropolis vs the committed JAX run: z {zmax}")
    say(f"(b) against examples/ferromagnet_mc_chain_counts.npz: L = 1..4, "
        f"{MC_BLOCKS} blocks, largest z {zmax:.4f} (< 5)")
    analytic = ferromagnet.analytic_p_history(
        beta=MC["beta"], J=MC["J"], h=MC["h"], t_max=MC_T_MAX,
        t_steps=MC["num_steps"], p0_pair=1 / MC["sites_per_pair"],
        device=dev)
    half = MC["num_steps"] // 2
    mc_mean = (counts[..., 1] / N)[:, half:].mean()
    an_mean = analytic[half:, 0].mean()
    if not 0.3 * an_mean < mc_mean < 3.0 * an_mean:
        raise AssertionError(f"p(L=1): MC {mc_mean} vs analytic {an_mean}")
    say(f"(b) p(L=1) second half: MC {mc_mean:.6e}, analytic {an_mean:.6e} "
        f"(ratio {mc_mean / an_mean:.4f}, band 0.3-3)")
    # K28 against its plain version, all chains, the first 20 steps.
    thr = ferromagnet.acceptance_table(MC["J"], MC["h"], MC["beta"])
    pair = torch.rand((T, N), generator=gen, dtype=torch.float64,
                      device=dev) < 1.0 / MC["sites_per_pair"]
    chains0 = (pair | torch.roll(pair, 1, dims=1)).to(torch.int32)
    shape = (T, MC_CHECK_STEPS, rounds, rs)
    sites = torch.randint(0, N, shape, generator=gen, dtype=torch.int32,
                          device=dev)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
    ck, cp = chains0.clone(), chains0.clone()
    got = ferromagnet.metropolis(ck, sites, u, thr, True)
    want = ferromagnet.metropolis_plain(
        cp, sites, u, torch.as_tensor(thr, device=dev), True)
    torch.cuda.synchronize()
    err = max(int((got - want).abs().max()), int((ck - cp).abs().max()))
    if not (torch.equal(got, want) and torch.equal(ck, cp)):
        raise AssertionError("K28 != plain")
    say(f"(b) K28 == plain bit for bit: {T} chains, {MC_CHECK_STEPS} steps, "
        f"counts and chains ({int((ck != chains0).sum())} sites flipped)")
    for c_ in MC_SHAPES:
        ferromagnet.k28_check(c_["N"], c_["rounds"], c_["rs"])
        x0 = (torch.rand((c_["T"], c_["N"]), generator=gen, device=dev)
              < 0.3).to(torch.int32)
        xshape = (c_["T"], c_["steps"], c_["rounds"], c_["rs"])
        xs = torch.randint(0, c_["N"], xshape, generator=gen,
                           dtype=torch.int32, device=dev)
        xu = torch.rand(xshape, generator=gen, dtype=torch.float64,
                        device=dev)
        xk, xp = x0.clone(), x0.clone()
        got = ferromagnet.metropolis(xk, xs, xu, thr, True)
        want = ferromagnet.metropolis_plain(
            xp, xs, xu, torch.as_tensor(thr, device=dev), True)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()),
                  int((xk - xp).abs().max()))
        if not (torch.equal(got, want) and torch.equal(xk, xp)
                and not torch.equal(xk, x0)):
            raise AssertionError(f"K28 != plain at {c_}")
        say(f"(b) K28 == plain bit for bit at {c_['T']} chains x {c_['N']} "
            f"sites, {c_['steps']} steps of {c_['rounds']} rounds of "
            f"{c_['rs']}: counts and chains")
    # K28 on long chains.
    c_ = MC_LONG
    ferromagnet.k28_check(c_["N"], c_["rounds"], c_["rs"])
    long0 = (torch.rand((c_["T"], c_["N"]), generator=gen, device=dev)
             < 0.3).to(torch.int32)
    lshape = (c_["T"], c_["steps"], c_["rounds"], c_["rs"])
    lsites = torch.randint(0, c_["N"], lshape, generator=gen,
                           dtype=torch.int32, device=dev)
    lu = torch.rand(lshape, generator=gen, dtype=torch.float64, device=dev)
    lk, lp = long0.clone(), long0.clone()
    got = ferromagnet.metropolis(lk, lsites, lu, thr, True)
    want = ferromagnet.metropolis_plain(
        lp, lsites, lu, torch.as_tensor(thr, device=dev), True)
    torch.cuda.synchronize()
    err = max(err, int((got - want).abs().max()), int((lk - lp).abs().max()))
    if not (torch.equal(got, want) and torch.equal(lk, lp)
            and not torch.equal(lk, long0)):
        raise AssertionError("K28 on bit chains != plain")
    bits_ms = cuda_ms(lambda: ferromagnet.metropolis(
        long0.clone(), lsites, lu, thr, False), 3, warmup=1)
    say(f"(b) K28 on long chains == plain bit for bit: {c_['T']} chains x "
        f"{c_['N']} sites "
        f"({ferromagnet.k28_bytes(c_['N'], c_['rounds'], c_['rs'])}"
        f" bytes of shared memory a block), "
        f"{c_['steps']} steps of {c_['rounds']} rounds of {c_['rs']}; "
        f"{bits_ms * 1e3 / c_['steps']:.3f} us a step")
    # K28 alone at the main path's launch (one chunk of steps).
    chunk = ferromagnet.DRAW_CHUNK // (T * rounds * rs)
    shape = (T, chunk, rounds, rs)
    sites = torch.randint(0, N, shape, generator=gen, dtype=torch.int32,
                          device=dev)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
    ck = chains0.clone()
    ms = cuda_ms(lambda: ferromagnet.metropolis(ck, sites, u, thr, False), 3,
                 warmup=1)
    plain_ms = once_ms(lambda: ferromagnet.metropolis_plain(
        chains0.clone(), sites, u, torch.as_tensor(thr, device=dev), False))
    nbytes_ = (sites.numel() * 4 + u.numel() * 8 + 2 * ck.numel() * 4
               + T * chunk * 6 * 4)
    bound = nbytes_ / HBM_BYTES_PER_S * 1e3
    say(f"(b) K28 alone, {chunk} steps x {T} chains: {ms:.4f} ms "
        f"({ms * 1e3 / chunk:.3f} us a step) against a bound of "
        f"{bound:.4f} ms ({nbytes_ / 1e6:.1f} MB); plain {plain_ms:.2f} ms")
    record["K28"] = {
        "name": K28[0], "route": "cuda", "source": K28[1], "replaces": K28[2],
        "launches": c["K28"], "max_abs_err": err,
        "match": f"bit-identical to metropolis_plain, {T} chains x {N} "
                 f"sites, {MC_CHECK_STEPS} steps, counts and chains",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None, "steps_per_launch": chunk,
        "us_a_step": ms * 1e3 / chunk,
        "smem_bytes": ferromagnet.k28_bytes(N, rounds, rs),
        "shapes_held": MC_SHAPES,
        "run_s": secs, "steps_per_s": steps / secs,
        "chain_steps_per_s": steps * T / secs, "largest_z": zmax,
        "p1_mc_over_analytic": mc_mean / an_mean,
        "long_chains": {**c_, "us_a_step": bits_ms * 1e3 / c_["steps"]}}


def example_rows():
    """The 12 rows of examples/autocatalysis.py (its PARAM_SETS)."""
    src = (EXAMPLES / "autocatalysis.py").read_text()
    scope = {}
    exec(src[src.index("PARAM_SETS = {"):src.index("STYLES")], scope)
    return np.array(sum(scope["PARAM_SETS"].values(), []))


def ac_rhs_numpy(t, y, p):
    """The rate law in numpy, for scipy's reference solves."""
    fa, ua, sa, fb, ub, sb, add, rem = p
    ca, cb, cm = y
    form_a, form_b = fa * cm * cm, fb * cm * cm
    auto_a, auto_b = ua * ca * cm * cm, ub * cb * cm * cm
    sda, sdb = fa / sa * ca, fb / sb * cb
    ada, adb = ua / sa * ca * ca, ub / sb * cb * cb
    return [form_a + auto_a - sda - ada - rem * ca,
            form_b + auto_b - sdb - adb - rem * cb,
            2 * (sda + sdb) + 2 * (ada + adb) - 2 * (form_a + form_b)
            - 2 * (auto_a + auto_b) - rem * cm + add]


def ac_part(dev, record):
    """(c): the autocatalysis sweep, its gates and the equilibrium."""
    from scipy.integrate import solve_ivp

    rows = example_rows()
    autocatalysis.integrate_sweep(rows, AC_TS[:3], device=dev)  # warm
    (ys, info), c, secs = comp_path(
        f"(c) autocatalysis sweep, {len(rows)} rows x {len(AC_TS)} samples",
        lambda: autocatalysis.integrate_sweep(rows, AC_TS, device=dev),
        ["K29"])
    acc = info["num_accepted"].cpu().numpy()
    rej = info["num_rejected"].cpu().numpy()
    ys_np = ys.cpu().numpy()
    if not (np.isfinite(ys_np).all() and (acc >= len(AC_TS) - 1).all()
            and (ys_np[:, -1] != 0).any(axis=1).all()):
        raise AssertionError("sweep: a sample not reached or not finite")
    say(f"(c) sweep {secs:.4f} s; accepted steps {acc.tolist()}, rejected "
        f"{rej.tolist()}")
    worst = 0.0
    for b, row in enumerate(rows):
        sol = solve_ivp(ac_rhs_numpy, (AC_TS[0], AC_TS[-1]), row[:3],
                        method="DOP853", rtol=1e-12, atol=1e-14,
                        args=(row[3:],))
        ref = sol.y[:, -1]
        worst = max(worst, float(np.abs(ys_np[b, -1] - ref).max()
                                 / np.abs(ref).max()))
    if not worst < 1e-6:
        raise AssertionError(f"sweep vs scipy DOP853: {worst}")
    closed = [b for b, row in enumerate(rows) if row[9] == row[10] == 0]
    cons = max(float(np.abs(tot / tot[0] - 1).max()) for tot in (
        2 * ys_np[b, :, 0] + 2 * ys_np[b, :, 1] + ys_np[b, :, 2]
        for b in closed))
    if not cons < 1e-7:
        raise AssertionError(f"closed rows' 2A + 2B + M drifts {cons}")
    t0 = time.perf_counter()
    y_eq, residual = autocatalysis.find_equilibrium(
        ys_np[-4, -1], rows[-4, 3:], device=dev)
    eq_s = time.perf_counter() - t0
    if not residual < 1e-10:
        raise AssertionError(f"find_equilibrium residual {residual}")
    say(f"(c) final states within {worst:.3e} (relative) of scipy DOP853 at "
        f"1e-12; closed rows {closed} conserve 2A + 2B + M to {cons:.3e}; "
        f"find_equilibrium {eq_s:.3f} s, residual {residual:.3e}, "
        f"y {y_eq.tolist()}")
    # K29 against its plain version on the first 1,001 samples.
    y0 = torch.as_tensor(rows[:, :3].copy(), device=dev)
    p = torch.as_tensor(rows[:, 3:].copy(), device=dev)
    ts = torch.as_tensor(AC_TS[:AC_CHECK], device=dev)
    (yk, ak, rk), (yp, ap, rp) = (
        autocatalysis.dopri5_batch(y0, p, ts, 200_000),
        autocatalysis._solve_batch_plain(y0, p, ts, 200_000))
    torch.cuda.synchronize()
    if not (torch.equal(ak, ap) and torch.equal(rk, rp)):
        raise AssertionError("K29 and plain take different steps")
    err = float((yk - yp).abs().max())
    rel = float(((yk - yp).abs() / yp.abs().clamp_min(1e-300)).max())
    if not rel <= 1e-12:
        raise AssertionError(f"K29 != plain: rel {rel}")
    bits = torch.equal(yk, yp)
    say(f"(c) K29 vs plain, first {AC_CHECK} samples: equal steps a member; "
        f"{'bit for bit' if bits else f'largest rel diff {rel:.3e}'}")
    ms = cuda_ms(lambda: autocatalysis.dopri5_batch(
        y0, p, torch.as_tensor(AC_TS, device=dev), 200_000), 3, warmup=1)
    ms_check = cuda_ms(lambda: autocatalysis.dopri5_batch(y0, p, ts,
                                                          200_000), 3)
    plain_ms = once_ms(lambda: autocatalysis._solve_batch_plain(
        y0, p, ts, 200_000))
    steps = acc + rej
    flops = float(steps.sum()) * k29_flops_per_step()
    ops_ms = flops / FP64_FLOPS * 1e3
    bytes_ms = (ys.numel() + rows.size + len(AC_TS)) * 8 / HBM_BYTES_PER_S * 1e3
    say(f"(c) K29 alone: the sweep {ms:.4f} ms ({ms * 1e3 / steps.max():.3f} "
        f"us a step of the longest member, {int(steps.max())} steps), first "
        f"{AC_CHECK} samples {ms_check:.4f} ms, plain there "
        f"{plain_ms:.2f} ms; bound {max(ops_ms, bytes_ms):.6f} ms "
        f"(operations {ops_ms:.6f}, bytes {bytes_ms:.6f})")
    record["K29"] = {
        "name": K29[0], "route": "cuda", "source": K29[1], "replaces": K29[2],
        "launches": c["K29"], "max_abs_err": err,
        "match": (f"bit-identical to _solve_batch_plain, first {AC_CHECK} "
                  "samples, equal steps" if bits else
                  f"rel {rel:.3e} of _solve_batch_plain, first {AC_CHECK} "
                  "samples, equal steps"),
        "ms": ms, "plain_ms": plain_ms, "plain_at": f"first {AC_CHECK} "
        "samples (the sweep's plain run would take minutes)",
        "ms_first_samples": ms_check,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "longest_member_steps": int(steps.max()),
        "flops_per_step": k29_flops_per_step(), "sweep_s": secs,
        "scipy_rel": worst, "conservation": cons,
        "equilibrium": {"seconds": eq_s, "residual": residual}}


def companions_phase(dev, kernels):
    """Phase 15: (a)-(c) above, and the `kernels` line's K27, K28 and
    K29. Builds the library on first use when run alone."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    t0 = time.perf_counter()
    record = {}
    ssa_part(dev, record)
    mc_part(dev, record)
    ac_part(dev, record)
    seconds = time.perf_counter() - t0
    say(f"phase 15's time on the card: {seconds:.2f} s (budget "
        f"{COMP_BUDGET_S:.0f} s)")
    if not seconds < COMP_BUDGET_S:
        raise AssertionError(f"phase 15 took {seconds:.2f} s")
    for k in ("K27", "K28", "K29"):
        kernels[k] = record[k]


# --- Phase 16: reverse-mode derivatives (K30, K6's adjoint rows) --------------

K30 = ("K30 dense_vjp", SRC + "dense_vjp.cu",
       "jax.vjp of the JAX package's engine/dense.py:441 dy_dt_dense at "
       "ode/steady.py:419,438, ode/fixed.py:121 and engine/parametric.py:153 "
       "(XLA)")
K6_ADJ = ("K6 dop853_arith: DP5's adjoint rows", SRC + "dop853.cu",
          "the backward of the JAX package's ode/fixed.py:74 "
          "_odeint_fixed_impl (XLA's transpose of its scan, jax.checkpoint "
          "on each interval)")
EX2P, EX4V2P = "ex2-ferromagnetic-chain-p", "ex4var2-chemical-turing-p"
# (a)'s programs: (label, tag, cl_k, dual, parametric). ex2 cl_k 5 is the
# inverse design's program (the block form), ex4 cl_k 5 the grid form.
VJP_CASES = [("ex2 cl_k 5", EX2, 5, False, False),
             ("ex2-p cl_k 4", EX2P, 4, False, True),
             ("ex4var2-p cl_k 4", EX4V2P, 4, False, True),
             ("ex4 cl_k 5", EX4, 5, False, False),
             ("ex3 dual cl_k 4", EX3, 4, True, False)]
VJP_TIMED_K8 = (EX4, 8)
# examples/ex2_inverse_design.py, ex4var2_thermo_sensitivity.py and
# ex2_equilibrium.py: their geometry.
INV = dict(cl_k=5, ts=np.linspace(0.0, 30.0, 61), n_sub=8, guess=1 / 500.0,
           target=1 / 77.0, obs=0b01100, steps=12)
SENS = dict(cl_k=4, ts=np.linspace(0.0, 100.0, 11), n_sub=100, seq="IOIO",
            syms="ABCDIOPXSE")
EQ = dict(cl_k=4, tol=1e-13, beta=0.7)
# The plain versions of every kernel that (b)-(d) run: K30 and K6's
# rows, and the forward's K3, K4, K5, K25 and K26.
REV_PLAIN = [tdense.dense_vjp_plain, tdense.dense_jvp_plain,
             tdense.sweep_plain, tdense.signature_weights_plain,
             tdense.pyramid_plain, tsteady.steady_aug_plain, *dop853.PLAIN]
REV_RTOL = {"inverse": 1e-6, "sensitivity": 1e-5, "equilibrium": 1e-5}


def zero_rev_counts():
    for f in (tdense.dense_vjp, tdense.sweep, tdense.pyramid,
              tdense.dense_jvp, tsteady.steady_aug, *dop853.KERNELS):
        f.launches = 0
    dop853.stage.adjoint_launches = 0
    for f in REV_PLAIN:
        f.calls = 0


def rev_counts():
    return {"K30": tdense.dense_vjp.launches,
            "K6_adjoint": dop853.stage.adjoint_launches,
            "K6": sum(f.launches for f in dop853.KERNELS)
            - dop853.stage.adjoint_launches,
            "K5": tdense.sweep.launches, "K3": tdense.pyramid.launches,
            "K25": tdense.dense_jvp.launches,
            "K26": tsteady.steady_aug.launches,
            "plain": sum(f.calls for f in REV_PLAIN)}


def rev_path(label, fn, need=("K30", "K6_adjoint", "K5")):
    """Runs one path of phase 16 with the counts set to 0 just before and
    read just after; raises unless each kernel in ``need`` launched and
    no plain version ran. Returns (result, counts, seconds)."""
    torch.cuda.synchronize()
    zero_rev_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = rev_counts()
    say(f"{label}: " + ", ".join(f"{x} {n}" for x, n in c.items()
                                 if x != "plain")
        + f" launches, plain calls {c['plain']}; {seconds:.2f} s")
    if c["plain"]:
        raise AssertionError(f"{label}: a plain version ran")
    if not all(c[x] for x in need):
        raise AssertionError(f"{label}: {need} did not all launch")
    return out, c, seconds


def median_ms(fn, reps=25):
    """The median device milliseconds of ``reps`` calls of ``fn``, each
    between its own CUDA events, queued behind a sleep so that the host's
    pacing does not show."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def k30_bound(dp, want_w):
    """(bound ms, bound_by, bytes, ops) of one K30 call: p and u read and
    p_bar written once, w_const read (and w_bar written) once, the plan
    read once; against the float64 operations of its phases (each live
    element's product and digit sum, its cotangent's A terms and two
    products, the ratio partials, the chains and the pyramid's terms)."""
    prog = dp.prog
    vp = tdense.vjp_tables(dp)["plan"]
    n, a = prog.state_size, prog.size_a
    nbytes = (24 * n + 8 * prog.num_worlds * (2 if want_w else 1)
              + vp.nbytes + dp.pair_num.numel() * 8 + dp.pair_const.numel() * 8
              + dp.w_num.numel() * 8)
    live = sum(st.n for st in dp.plan.steps if st.kind != tdense.INTERIOR)
    tapes = 1 + prog.dual
    ops = (live * (2 * a + 4) + tapes * vp.rat_len * 10
           + prog.w_num.size * 14 + (n + tdense.low_size(prog)) * (2 * a + 2))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def vjp_states(gen, n, a, dev):
    """(label, p): a positive p, one with a third of its windows exactly 0
    (ties in the guarded ratio), one whose contexts starting with symbol
    0 are dead (zero contexts)."""
    pos = -torch.log1p(-torch.rand(n, generator=gen, device=dev,
                                   dtype=torch.float64))
    pos = pos / pos.sum()
    zeros = torch.where(torch.rand(n, generator=gen, device=dev) < 1 / 3,
                        0.0, pos)
    dead = pos.clone()
    dead[: n // a] = 0.0
    return [("positive", pos), ("zeros and ties", zeros / zeros.sum()),
            ("dead contexts", dead / dead.sum())]


def vjp_against_plain(dev, gen, record):
    """(a): K30 against `dense_vjp_plain` bit for bit (p_bar and w_bar) at
    each of `VJP_CASES` in every launch form it can take, at the three
    `vjp_states` (a run-time w_const for the parametric rules); K30 timed
    at each program in its own form and at ex4 cl_k 8 beside its bound."""
    times = {}
    for label, tag, k, dual, parametric in VJP_CASES:
        if parametric:
            pd = tparam.ParametricDense(tag, k, device=dev)
            dp = pd.dp
            defaults = {x: float(v) for x, v in
                        pd.problem.param_defaults.items()}
            w_rt = pd.consts({x: v * 1.1 for x, v in defaults.items()})
        else:
            prog = (tdense.compile_dense_dual(tag, k) if dual
                    else tdense.compile_dense(tag, k))
            dp = tdense.device_program(prog, dev)
            w_rt = None
        prog = dp.prog
        n = prog.state_size
        chosen = dp.form
        forms = tdense.forms_for(dp)
        checks = 0
        for state, p in vjp_states(gen, n, prog.size_a, dev):
            u = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
            want_p, want_w = tdense.dense_vjp_plain(dp, p, u, w_const=w_rt,
                                                    want_w=True)
            for form in forms:
                dp.form = form
                got_p, got_w = tdense.dense_vjp(dp, p, u, w_const=w_rt,
                                                want_w=True)
                torch.cuda.synchronize()
                err = max(float((got_p - want_p).abs().max()),
                          float((got_w - want_w).abs().max()))
                record["K30"] = max(record["K30"], err)
                if not (torch.equal(got_p, want_p)
                        and torch.equal(got_w, want_w)):
                    raise AssertionError(
                        f"K30 != dense_vjp_plain: {label}, {state}, "
                        f"{tdense.form_name(form)}, max |diff| {err}")
                checks += 1
            dp.form = chosen
        vp = tdense.vjp_tables(dp)["plan"]
        p = vjp_states(gen, n, prog.size_a, dev)[0][1]
        u = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        low = tdense.pyramids(prog, p)
        ms = median_ms(lambda: tdense.dense_vjp(dp, p, u, low, w_rt, True))
        plain_ms = median_ms(lambda: tdense.dense_vjp_plain(
            dp, p, u, low, w_rt, True), 5)
        bound, by, nbytes, ops = k30_bound(dp, True)
        times[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, bytes=nbytes, ops=ops,
                            form=tdense.form_name(chosen),
                            plan_bytes=vp.nbytes)
        say(f"K30 {label} ({tdense.form_name(chosen)}; {checks} checks, "
            f"every form {[tdense.form_name(f) for f in forms]}): "
            f"{ms * 1e3:.2f} us median of 25; bound {bound * 1e3:.3f} us "
            f"({by}: {nbytes / 1e6:.3f} MB, {ops / 1e6:.3f} M flops); plain "
            f"{plain_ms:.2f} ms; plan {vp.nbytes / 1e6:.3f} MB")
    tag, k = VJP_TIMED_K8
    t0 = time.perf_counter()
    dp = tdense.device_program(tdense.compile_dense(tag, k), dev)
    vp = tdense.vjp_tables(dp)["plan"]
    plan_s = time.perf_counter() - t0
    n = dp.prog.state_size
    p = vjp_states(gen, n, dp.prog.size_a, dev)[0][1]
    u = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    low = tdense.pyramids(dp.prog, p)
    ms = median_ms(lambda: tdense.dense_vjp(dp, p, u, low), 20)
    bound, by, nbytes, ops = k30_bound(dp, False)
    pbar, _ = tdense.dense_vjp(dp, p, u, low)
    if not bool(torch.isfinite(pbar).all()):
        raise AssertionError("K30 at ex4 cl_k 8: a non-finite p_bar")
    times[f"ex4 cl_k {k}"] = dict(ms=ms, plain_ms=None, bound_ms=bound,
                                  bound_by=by, bytes=nbytes, ops=ops,
                                  form=tdense.form_name(dp.form),
                                  plan_bytes=vp.nbytes)
    say(f"K30 ex4 cl_k {k} ({tdense.form_name(dp.form)}, {n} states, "
        f"{dp.plan.work_size} live elements): {ms:.3f} ms median of 20; "
        f"bound {bound:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} G flops); plan {vp.nbytes / 1e6:.1f} MB, made in "
        f"{plan_s:.1f} s with the sweep's")
    del dp, vp, p, u, low, pbar
    torch.cuda.empty_cache()
    record["K30_times"] = times


def adjoint_rows_against_plain(dev, gen, record):
    """K6's adjoint rows (`dop853.DP5_ADJ_ROWS`, `DP5_ADJ_SUM`) against
    their plain versions bit for bit at (b)'s and (c)'s state sizes, each
    timed at (c)'s beside its bound (the row's terms and the base read,
    the output written)."""
    times = {}
    for n in (2 ** INV["cl_k"], 10 ** SENS["cl_k"]):
        adj = dop853.rows_tensor(dop853.DP5_STAGES + 1, n, dev)
        adj.copy_(torch.randn(adj.shape, generator=gen, device=dev,
                              dtype=torch.float64))
        base = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        out = torch.empty_like(base)
        ref = torch.empty_like(base)
        for row in dop853.DP5_ADJ_ROWS + (dop853.DP5_ADJ_SUM,):
            h = 1.0 if row == dop853.DP5_ADJ_SUM else 0.0375
            dop853.stage(base, adj, h, row, out)
            dop853.stage_plain(base, adj, h, dop853.tableau_terms(row), ref)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            record["K6_adj"] = max(record["K6_adj"], err)
            if not torch.equal(out, ref):
                raise AssertionError(f"K6 adjoint row {row} != plain at "
                                     f"n {n}: {err}")
            if n == 10 ** SENS["cl_k"]:
                terms = len(dop853.TABLEAU[row])
                ms = median_ms(lambda: dop853.stage(base, adj, h, row, out))
                plain_ms = median_ms(lambda: dop853.stage_plain(
                    base, adj, h, dop853.tableau_terms(row), ref))
                bound = 8 * n * (terms + 2) / HBM_BYTES_PER_S * 1e3
                times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  terms=terms)
    for row, t in times.items():
        say(f"K6 adjoint row {row} ({t['terms']} terms) at n = "
            f"{10 ** SENS['cl_k']}: {t['ms'] * 1e3:.2f} us median of 25, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us (bytes)")
    record["K6_adj_times"] = times


def inverse_design(dev, record):
    """(b) examples/ex2_inverse_design.py through the port: ex2 cl_k 5,
    61 samples on [0, 30], n_sub 8, p_pair from 1/500 to the hidden 1/77
    by Newton on the squared residual of p(DUUD)(30) (x -= 2 v / g,
    clipped to [1e-5, 0.2]); the first gradient against a central
    difference of the port's forward solve (rtol 1e-6); the loss below
    1e-20 within the example's 12 steps."""
    cfg = INV
    k = cfg["cl_k"]
    fn, _ = tengine.build_dy_dt(EX2, k, device=dev)

    def final(x):
        ys = odeint_fixed(lambda y, t: fn(y),
                          ferromagnet_p0_traced(k, x), cfg["ts"],
                          n_sub=cfg["n_sub"])
        return ys[-1, cfg["obs"]]

    def at(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    target = final(at(cfg["target"])).detach()

    def loss_grad(x):
        xl = at(x).requires_grad_(True)
        v = (final(xl) - target) ** 2
        (g,) = torch.autograd.grad(v, xl)
        return float(v.detach()), float(g)

    def newton():
        x = cfg["guess"]
        v0, g0 = loss_grad(x)
        hist = [(x, v0)]
        v, g = v0, g0
        for _ in range(cfg["steps"]):
            if v < 1e-28:
                break
            x = min(max(x - 2.0 * v / g, 1e-5), 0.2)
            v, g = loss_grad(x)
            hist.append((x, v))
        return g0, hist

    (g0, hist), counts, seconds = rev_path("(b) inverse design", newton)
    eps = 1e-7
    with torch.no_grad():
        fd = (float((final(at(cfg["guess"] + eps)) - target) ** 2)
              - float((final(at(cfg["guess"] - eps)) - target) ** 2)) / (
            2 * eps)
    rel = abs(g0 - fd) / abs(fd)
    say(f"(b) first gradient {g0:.12e}, central difference {fd:.12e} "
        f"(rel {rel:.2e}); Newton: " + ", ".join(
            f"{x:.12g} ({v:.2e})" for x, v in hist))
    if not rel <= REV_RTOL["inverse"]:
        raise AssertionError("(b) the gradient misses the central "
                             "difference")
    best = min(v for _, v in hist)
    if not (best < 1e-20 and abs(hist[-1][0] - cfg["target"]) < 1e-6):
        raise AssertionError(f"(b) no recovery: loss {best:.3e}")
    record["paths"]["inverse design"] = dict(
        counts=counts, seconds=seconds, newton_steps=len(hist) - 1,
        loss=best, grad_rel=rel)


def sensitivity(dev, record):
    """(c) `rate_sensitivity` at examples/ex4var2_thermo_sensitivity.py's
    geometry: ex4var2-chemical-turing-p cl_k 4, 11 samples on [0, 100],
    n_sub 100, p(IOIO) at T; every parameter's gradient against a
    central difference of two forward solves (rtol 1e-5)."""
    cfg = SENS
    k = cfg["cl_k"]
    pd = tparam.ParametricDense(EX4V2P, k, device=dev)
    defaults = {x: float(v) for x, v in pd.problem.param_defaults.items()}
    proj = seq_prob_projector([[cfg["syms"].index(c) for c in cfg["seq"]]],
                              pd.prog.size_a, k)
    p0 = chemical_turing_v2_p0(k).ravel()

    def obs(y):
        return proj(y[None, :])[0, 0]

    (value, grads), counts, seconds = rev_path(
        "(c) rate_sensitivity", lambda: tparam.rate_sensitivity(
            EX4V2P, k, p0, cfg["ts"], obs, n_sub=cfg["n_sub"], device=dev))

    def solve_at(prm):
        ys = odeint_fixed(lambda y, t, w: pd.dy_dt(y, w), p0, cfg["ts"],
                          n_sub=cfg["n_sub"], args=pd.consts(prm),
                          device=dev)
        return float(obs(ys[-1]))

    worst = 0.0
    for name in sorted(defaults):
        eps = 1e-6 * max(1.0, abs(defaults[name]))
        hi, lo = dict(defaults), dict(defaults)
        hi[name] += eps
        lo[name] -= eps
        fd = (solve_at(hi) - solve_at(lo)) / (2 * eps)
        g = float(grads[name])
        rel = abs(g - fd) / max(abs(fd), 1e-300)
        say(f"(c) d p({cfg['seq']}) / d {name}: {g:+.12e}, central "
            f"difference {fd:+.12e} (rel {rel:.2e})")
        if not abs(g - fd) <= REV_RTOL["sensitivity"] * abs(fd) + 1e-15:
            raise AssertionError(f"(c) the gradient in {name} misses the "
                                 "central difference")
        worst = max(worst, rel)
    say(f"(c) p({cfg['seq']})(T) = {float(value):.12e}; {len(defaults)} "
        f"parameters, worst rel {worst:.2e}")
    record["paths"]["rate_sensitivity"] = dict(
        counts=counts, seconds=seconds, params=len(defaults),
        worst_rel=worst)


def equilibrium(dev, record):
    """(d) the implicit gradient at examples/ex2_equilibrium.py's
    geometry: ex2-ferromagnetic-chain-p cl_k 4, tol 1e-13, m = 2 p(U) - 1
    at beta 0.7 from the Gibbs measure at 0.65 (a continuation step);
    dm/dbeta against central differences of two solves and the analytic
    Ising derivative (rtol 1e-5)."""
    cfg = EQ
    k = cfg["cl_k"]
    pd = tparam.ParametricDense(EX2P, k, device=dev)
    defaults = {x: torch.tensor(float(v), dtype=torch.float64)
                for x, v in pd.problem.param_defaults.items()}
    solve = tsteady.make_steady_state(lambda p, w: pd.dy_dt(p, w), size_a=2,
                                      cl_k=k, tol=cfg["tol"],
                                      probe_args=pd.consts(defaults),
                                      device=dev)
    guess = torch.as_tensor(ferromagnet.ising_gibbs_windows(
        k, J_eff=2.0, h=-0.25, beta=cfg["beta"] - 0.05), device=dev)

    def m_of(beta):
        prm = dict(defaults)
        prm["beta"] = beta
        p_inf, info = solve(guess, pd.consts(prm))
        if not info.converged:
            raise AssertionError(f"(d) no convergence: {info}")
        return 2.0 * p_inf.reshape(2, -1).sum(1)[1] - 1.0

    def grad():
        b = torch.tensor(cfg["beta"], dtype=torch.float64, requires_grad=True)
        m = m_of(b)
        (g,) = torch.autograd.grad(m, b)
        return float(m.detach()), float(g)

    (m, g), counts, seconds = rev_path("(d) implicit gradient", grad,
                                       need=("K30", "K5", "K25", "K26"))
    eps = 1e-4
    fd = (float(m_of(torch.tensor(cfg["beta"] + eps, dtype=torch.float64)))
          - float(m_of(torch.tensor(cfg["beta"] - eps,
                                    dtype=torch.float64)))) / (2 * eps)

    def analytic_m(beta):
        pg = ferromagnet.ising_gibbs_windows(1, J_eff=2.0, h=-0.25,
                                             beta=beta)
        return 2.0 * pg[1] - 1.0

    e2 = 1e-6
    exact = (analytic_m(cfg["beta"] + e2) - analytic_m(cfg["beta"] - e2)) / (
        2 * e2)
    say(f"(d) m({cfg['beta']}) = {m:.12f} (analytic "
        f"{analytic_m(cfg['beta']):.12f}); dm/dbeta {g:.12e}, central "
        f"difference {fd:.12e}, analytic {exact:.12e}")
    for what, want in (("central difference", fd), ("analytic", exact)):
        if not abs(g - want) <= REV_RTOL["equilibrium"] * abs(want):
            raise AssertionError(f"(d) the implicit gradient misses the "
                                 f"{what}")
    if counts["K6_adjoint"]:
        raise AssertionError("(d) ran the fixed grid's adjoint")
    record["paths"]["implicit gradient"] = dict(counts=counts,
                                                seconds=seconds)


def reverse_phase(dev, kernels):
    """Phase 16: (a)-(d), and the `kernels` line's K30 and K6 adjoint
    entries; (b)-(d) are the phase's main path, K30 and K6's adjoint rows
    counted over them."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)
    record = {"K30": 0.0, "K6_adj": 0.0, "paths": {}}
    vjp_against_plain(dev, gen, record)
    adjoint_rows_against_plain(dev, gen, record)
    inverse_design(dev, record)
    sensitivity(dev, record)
    equilibrium(dev, record)
    paths = record["paths"]
    k30_total = sum(p["counts"]["K30"] for p in paths.values())
    adj_total = sum(p["counts"]["K6_adjoint"] for p in paths.values())
    if not (k30_total and adj_total):
        raise AssertionError("the main path did not launch K30 and K6's "
                             "adjoint rows")
    t30 = record["K30_times"]
    first = t30[VJP_CASES[0][0]]
    kernels["K30"] = {
        "name": K30[0], "route": "cuda", "source": K30[1],
        "replaces": K30[2], "launches": k30_total,
        "max_abs_err": record["K30"],
        "match": "bit-identical p_bar and w_bar to dense_vjp_plain at every "
                 "VJP_CASES program, state and launch form",
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None, "form": first["form"], "by_program": t30,
        "paths": {k: v["counts"] for k, v in paths.items()}}
    t6 = record["K6_adj_times"]
    row = dop853.DP5_ADJ_ROWS[0]
    kernels["K6_adjoint"] = {
        "name": K6_ADJ[0], "route": "cuda", "source": K6_ADJ[1],
        "replaces": K6_ADJ[2], "launches": adj_total,
        "max_abs_err": record["K6_adj"],
        "match": "bit-identical: rows 31-37 at n = 32 and 10,000",
        "ms": t6[row]["ms"], "plain_ms": t6[row]["plain_ms"],
        "bound_ms": t6[row]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "by_row": {str(r): t for r, t in t6.items()},
        "paths": {k: v for k, v in paths.items()}}
    say(f"phase 16: {time.perf_counter() - t0:.1f} s")


def main(dev=None):
    """Runs every phase on ``dev`` (the first CUDA card when None)."""
    if dev is None:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False; this "
                  "script needs an NVIDIA card", file=sys.stderr)
            return 1
        dev = torch.device("cuda")

    with Phase("1 device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        smi_line = smi.splitlines()[0]
        say(f"device: {kind} (count {count}); torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        say(smi_line)

    with Phase("2 build"):
        machines = {tag: ens.compile_decision_machine(tag)
                    for tag in TAGS + LATTICE_TAGS + [EX4V2]
                    + [register_fuzz(0, 2, True)]}
        jobs = {"K2-K10, K12, K13, K15, K16, K18-K22, K25-K30 "
                "(csrc/*.cu)": cuda.build,
                "expander (csrc/expander.cc, g++)": native.build}
        for tag, dm in machines.items():
            src = k1_source.k1_source(dm)
            jobs[f"K1, K11 {tag}"] = (
                lambda src=src: cuda.build_unit("k1", src))
        for tag in (EX2, EX4):
            src = k1_source.k1_source(machines[tag], 0.5)
            jobs[f"K1, K11 tempered {tag}"] = (
                lambda src=src: cuda.build_unit("k1", src))
        for tag in BITS_TAGS:
            src = bitslice_source.k14_source(
                machines[tag], tbs.machine_circuit(machines[tag]))
            jobs[f"K14 {tag}"] = (
                lambda src=src: cuda.build_unit("k14", src))
        bff_units = {}
        for tag in BFF_UNIT_TAGS:
            mm = tbff.compile_bff(tag)
            src = bff_bitslice_source.k17_source(
                mm, tbb.compile_bff_circuit(mm))
            jobs[f"K17 {tag}"] = (
                lambda src=src: cuda.build_unit("k17", src))
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {name: pool.submit(fn) for name, fn in jobs.items()}
            built = {name: f.result() for name, f in futures.items()}
        for name, (path, log, seconds) in built.items():
            tool = "g++" if name.startswith("expander") else "nvcc"
            say(f"{name}: {tool} {seconds:.2f} s -> {path.name}"
                if seconds else f"{name}: already built: {path.name}")
            for line in log.splitlines():
                if any(w in line for w in ("Compiling entry", "registers",
                                           "spill", "smem")):
                    say("  " + line.strip())
            if name.startswith("K17 "):
                regs = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln]
                spill = [ln.strip() for ln in log.splitlines()
                         if "spill" in ln]
                bff_units[name[4:]] = {"seconds": seconds,
                                       "registers": regs, "spill": spill}
        cuda.load()
        native.load()
        for dm in machines.values():
            k1_source.k1_library(dm)
        for tag in (EX2, EX4):
            k1_source.k1_library(machines[tag], 0.5)
        for tag in BITS_TAGS:
            bitslice_source.k14_library(machines[tag],
                                        tbs.machine_circuit(machines[tag]))
        for tag in BFF_UNIT_TAGS:
            mm = tbff.compile_bff(tag)
            bff_bitslice_source.k17_library(mm)

    kernels = {}
    max_err = {"K1": 0, "K2": 0}
    with Phase("3 main path"):
        dm = machines[MAIN_TAG]
        say(f"{MAIN_TAG}: {dm.n_cells} window cells, {len(dm.nodes)} "
            f"decision nodes, {dm.num_specs} write specs, "
            f"{len(ens._level_plan(dm))} levels")
        gen = torch.Generator(device=dev).manual_seed(0)
        ptape = torch.randint(0, 3, (B, L), generator=gen, device=dev,
                              dtype=torch.int32)
        dtape = torch.zeros((B, L), dtype=torch.int32, device=dev)
        gen_state = gen.get_state()
        torch.cuda.synchronize()

        def main_path(label):
            """One `run_ensemble` call from ``gen_state`` and one
            `window_counts`, counts set to 0 just before and read just
            after; returns the outputs and the call's device ms."""
            gen.set_state(gen_state)
            ens.plane_round.launches = 0
            ens.plane_round_plain.calls = 0
            ens.window_counts.launches = 0
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = ens.run_ensemble(gen, (ptape, dtape), dm, (NUM_STEPS, E),
                                   bitslice=False, device=dev)
            end.record()
            spd = ens.window_counts(out[0][0], dm.size_a, CL_K, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"plane_round": ens.plane_round.launches,
                        "window_counts": ens.window_counts.launches}
            plain_calls = ens.plane_round_plain.calls
            say(f"{label}: launches {launches}, plain round calls "
                f"{plain_calls}; wall {wall:.3f} s")
            if launches["plane_round"] != NUM_STEPS or plain_calls != 0:
                raise AssertionError("main path did not run K1 once a round")
            if launches["window_counts"] != 1:
                raise AssertionError("main path did not run K2")
            return out, spd, launches, start.elapsed_time(end)

        # The process's first call (cold) and the same call again (warm).
        ((pt, dt), (applied, times)), spd, launches, run_ms = main_path(
            "cold call")
        ((pt_w, dt_w), _), spd_w, _, warm_ms = main_path("warm call")
        if not (torch.equal(pt, pt_w) and torch.equal(dt, dt_w)
                and torch.equal(spd, spd_w)):
            raise AssertionError("the warm call differs from the cold one")
        del pt_w, dt_w

        # What came out: valid symbols, the run's bookkeeping, an SPD.
        if pt.shape != (B, L) or pt.dtype != torch.int32:
            raise AssertionError(f"tapes {tuple(pt.shape)} {pt.dtype}")
        for t in (pt, dt):
            if int(t.min()) < 0 or int(t.max()) >= dm.size_a:
                raise AssertionError("symbol out of range")
        if not torch.all(applied == B * E):
            raise AssertionError("applied counts")
        want_t = -math.log1p(-E / L) * NUM_STEPS
        if not (torch.all(torch.isfinite(times))
                and abs(float(times[-1]) - want_t) <= 1e-12 * want_t):
            raise AssertionError("times")
        if not (torch.all(torch.isfinite(spd))
                and abs(float(spd.sum()) - 1.0) < 1e-12
                and spd.shape == (dm.size_a**CL_K,)):
            raise AssertionError("window_counts")
        if int((dt != 0).sum()) == 0:
            raise AssertionError("the data tape never changed")
        ms_round, warm_round = run_ms / NUM_STEPS, warm_ms / NUM_STEPS
        for label, ms in (("cold", run_ms), ("warm", warm_ms)):
            say(f"run_ensemble, {label}: {ms:.3f} ms for {NUM_STEPS} rounds "
                f"(tape<->plane conversion included): "
                f"{ms / NUM_STEPS * 1e3:.2f} us/round, "
                f"{B * E * NUM_STEPS / (ms * 1e-3):.4e} transitions/s")
        say(f"first call's extra cost: {run_ms - warm_ms:.3f} ms")
        main_ref = {"start": (ptape, dtape), "gen_state": gen_state,
                    "tapes": (pt, dt),
                    "us_round": {"cold": run_ms * 1e3 / NUM_STEPS,
                                 "warm": warm_ms * 1e3 / NUM_STEPS}}
        say(f"SPD(cl_k={CL_K}) top windows: "
            f"{torch.topk(spd, 3).indices.tolist()}")

        # K1 over the run's own rounds: the same start and shifts (the
        # run's first draw), launched by run_rounds, once behind a
        # sleeping stream (device time) and once as the run launches
        # them (the host's pacing included).
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        replay = torch.Generator(device=dev)
        replay.set_state(gen_state)
        run_shifts = torch.randint(0, STRIDE, (NUM_STEPS,), generator=replay,
                                   device=dev, dtype=torch.int32)
        start_p = ens._tape_to_planes(ptape.to(torch.int8), STRIDE)
        start_d = ens._tape_to_planes(dtape.to(torch.int8), STRIDE)
        p_st, d_st = start_p.clone(), start_d.clone()
        replay_ms = cuda_ms(lambda: ens.run_rounds(dm, p_st, d_st,
                                                   run_shifts),
                            1, warmup=0) / NUM_STEPS
        if not (torch.equal(ens._planes_to_tape(p_st).to(torch.int32), pt)
                and torch.equal(ens._planes_to_tape(d_st).to(torch.int32),
                                dt)):
            raise AssertionError("replayed rounds differ from the run")
        p_st, d_st = start_p.clone(), start_d.clone()
        torch.cuda.synchronize()
        start.record()
        ens.run_rounds(dm, p_st, d_st, run_shifts)
        end.record()
        torch.cuda.synchronize()
        paced_ms = start.elapsed_time(end) / NUM_STEPS
        say(f"K1 over the run's {NUM_STEPS} rounds: {replay_ms * 1e3:.2f} "
            f"us a round device time, {paced_ms * 1e3:.2f} us a round as "
            f"launched; run_ensemble {ms_round * 1e3:.2f} us a round cold, "
            f"{warm_round * 1e3:.2f} warm")
        del start_p, start_d

        # K1 alone, on the run's final planes and a fresh random shift
        # sequence, as the run launches it.
        p_st = ens._tape_to_planes(pt.to(torch.int8), STRIDE)
        d_st = ens._tape_to_planes(dt.to(torch.int8), STRIDE)
        reps = 500
        shifts = torch.randint(0, STRIDE, (reps + 3,), generator=gen,
                               device=dev, dtype=torch.int32)
        it = iter(range(reps + 3))
        host = []
        k1_ms = cuda_ms(lambda: ens.plane_round(dm, p_st, d_st, shifts,
                                                next(it)), reps, host=host)
        host_c = []
        rounds_ms = cuda_ms(lambda: ens.run_rounds(dm, p_st, d_st, shifts),
                            1, warmup=1, host=host_c) / len(shifts)
        it = iter(range(5 + 3))
        k1_plain_ms = cuda_ms(lambda: ens.plane_round_plain(
            dm, p_st, d_st, shifts, next(it)), 5)
        k1_bound = k1_bytes(dm) / HBM_BYTES_PER_S * 1e3
        host_us = host[0] * 1e3
        host_c_us = host_c[0] * 1e3 / len(shifts)
        say(f"K1: {k1_ms * 1e3:.2f} us/round against a bound of "
            f"{k1_bound * 1e3:.2f} us ({k1_bytes(dm) / 1e6:.2f} MB at "
            f"3.35 TB/s): {k1_bound / k1_ms:.3f} of the bound; "
            f"plain {k1_plain_ms:.3f} ms; {rounds_ms * 1e3:.2f} us a round "
            f"by run_rounds")
        say(f"host a launch: {host_us:.2f} us by plane_round (checks + "
            f"one ctypes call a round), {host_c_us:.2f} us by run_rounds "
            f"(one check and one ctypes call for {len(shifts)} rounds)")

        # K2 on the main path's tape and on the tapes that tell skew
        # from index arithmetic, each beside its bound, its plain version
        # and torch.bincount on the same bins.
        k2_inputs = k2_tapes(pt, dt, gen)
        k2_times = {}
        for name, tape, size_a, cl_k in k2_inputs:
            bins = yardstick_bins(tape, size_a, cl_k)
            k2_times[name] = {
                "ms": cuda_ms(lambda: ens._window_counts_int(
                    tape, size_a, cl_k), 20),
                "plain_ms": cuda_ms(lambda: ens.window_counts_plain(
                    tape, size_a, cl_k), 3),
                "library_ms": cuda_ms(lambda: torch.bincount(
                    bins, minlength=size_a**cl_k), 20),
                "bound_ms": k2_bytes(size_a**cl_k) / HBM_BYTES_PER_S * 1e3,
                "bins": size_a**cl_k}
            del bins
            t = k2_times[name]
            say(f"K2 {name} ({t['bins']} bins): {t['ms']:.4f} ms against a "
                f"bound of {t['bound_ms']:.4f} ms "
                f"({t['bound_ms'] / t['ms']:.3f} of it); plain "
                f"{t['plain_ms']:.4f} ms; torch.bincount on the bins "
                f"{t['library_ms']:.4f} ms")
        k2_main = k2_times[k2_inputs[0][0]]

    with Phase("4 kernels against plain versions (full width)"):
        gen = torch.Generator(device=dev).manual_seed(1234)
        for tag in TAGS:
            dm = machines[tag]
            for events in (E, E_TAIL):
                kp, kd, u, err, changed = k1_against_plain(gen, tag, dm,
                                                           dev, events)
                max_err["K1"] = max(max_err["K1"], err)
                it = iter(range(10 ** 9))
                cycle = torch.arange(STRIDE, dtype=torch.int32, device=dev)
                ms = cuda_ms(lambda: ens.plane_round(
                    dm, kp, kd, cycle, next(it) % STRIDE,
                    u[0] if dm.has_choose else None), 200)
                bound = k1_bytes(dm, events)
                say(f"K1 {tag}, E={events}: {STRIDE} rounds bit-identical "
                    f"to plain; {changed} cells changed; {ms * 1e3:.2f} us "
                    "a round (every phase in turn), bound "
                    f"{bound / HBM_BYTES_PER_S * 1e6:.2f} us")
                del kp, kd, u

        # K2 on every timed tape; on one with symbols outside [0,
        # size_a): negative ones, and ones whose int32 rank wraps; on
        # 65,536 bins (256 KB, above the block's shared memory: the
        # histogram in device memory); and on rows of L - 1 symbols
        # (the symbol-a-lane loads, not the 16-byte ones).
        by_name = {name: t for name, t, _, _ in k2_inputs}
        uniform5 = by_name["uniform 5"]
        uniform2 = by_name["uniform 2, cl_k 14"]
        wrap = 2**32 // 5 ** (CL_K - 1) + 1
        pick = torch.randint(0, 10, (B, L), generator=gen, device=dev)
        negative = -torch.randint(1, 6, (B, L), generator=gen, device=dev,
                                  dtype=torch.int32)
        odd = torch.where(pick == 0, negative, uniform5)
        odd = torch.where(pick == 1, wrap, odd)
        odd = torch.where(pick == 2, -wrap, odd).to(torch.int32)
        del pick, negative
        more = [("out of range", odd, 5, CL_K),
                ("uniform 2, cl_k 16", uniform2, 2, 16),
                (f"uniform 5, L {L - 1}", uniform5[:, :L - 1].contiguous(),
                 5, CL_K)]
        for name, tape, size_a, cl_k in more:
            ms = cuda_ms(lambda: ens._window_counts_int(tape, size_a, cl_k),
                         20)
            say(f"K2 {name} ({size_a**cl_k} bins): {ms:.4f} ms")
        for name, tape, size_a, cl_k in k2_inputs + more:
            got = ens._window_counts_int(tape, size_a, cl_k)
            plain = ens.window_counts_plain(tape, size_a, cl_k)
            lib = torch.bincount(yardstick_bins(tape, size_a, cl_k),
                                 minlength=size_a**cl_k)
            torch.cuda.synchronize()
            max_err["K2"] = max(max_err["K2"], int(torch.maximum(
                (got - plain).abs().max(), (got - lib).abs().max())))
            if not (torch.equal(got, plain) and torch.equal(got, lib)):
                raise AssertionError(f"K2 != plain / bincount on {name}")
            say(f"K2 {name}: {size_a**cl_k} bins over "
                f"{tape.shape[0]}x{tape.shape[1]} sites "
                f"({int(got.sum())} counted) equal to plain and "
                "torch.bincount")
        del k2_inputs, by_name, more, uniform5, uniform2, odd, tape
        torch.cuda.empty_cache()

    kernels["K1"] = {
        "name": "K1 plane_round", "route": "cuda",
        "source": "chemical_kinetics_and_program_execution_torch/csrc/"
                  "plane_round.cuh",
        "replaces": K1_REPLACES, "launches": launches["plane_round"],
        "max_abs_err": max_err["K1"],
        "match": "bit-identical on ex5, ex4, ex2 at E=256 and E=255",
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None,
        "run_ms_per_round": {"cold": ms_round, "warm": warm_round},
        "run_rounds_ms_per_round": {"device": replay_ms,
                                    "as_launched": paced_ms},
        "host_us_per_launch": {"plane_round": host_us,
                               "run_rounds": host_c_us},
    }
    kernels["K2"] = {
        "name": "K2 window_counts", "route": "cuda",
        "source": "chemical_kinetics_and_program_execution_torch/csrc/"
                  "window_counts.cu",
        "replaces": K2_REPLACES, "launches": launches["window_counts"],
        "max_abs_err": max_err["K2"],
        "match": "exact vs plain and torch.bincount on every tape",
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": "bytes",
        "library_ms": k2_main["library_ms"], "tapes": k2_times,
    }


    with Phase("5 end to end against the CPU on a small input"):
        dm = ens.compile_decision_machine("ex4-chemical-turing")
        rng = np.random.RandomState(5)
        b, l, e, n = 64, 256, 16, 50
        tapes = [rng.randint(0, dm.size_a, (b, l)).astype(np.int32)
                 for _ in range(2)]
        shifts = rng.randint(0, l // e, n).astype(np.int32)
        u = rng.rand(n, b, e).astype(np.float32)
        out = []
        for d in (dev, torch.device("cpu")):
            p_st, d_st = (ens._tape_to_planes(
                torch.as_tensor(t, device=d).to(torch.int8), l // e)
                for t in tapes)
            ens.run_rounds(dm, p_st, d_st, torch.as_tensor(shifts, device=d),
                           torch.as_tensor(u, device=d))
            st = ens.PlaneState(p_st, d_st, batch=b, length=l)
            pt_, dt_ = st.tapes()
            out.append((pt_.cpu(), dt_.cpu(),
                        ens.window_counts(dt_, dm.size_a, 2,
                                          device=d).cpu()))
        for x, y in zip(*out):
            if not torch.equal(x, y):
                raise AssertionError("card and CPU runs differ")
        say(f"ex4 {n} rounds at B={b}, L={l}: card == CPU (tapes and "
            "window counts)")

    with Phase("6 the exact SPD closure (K3-K6)"):
        dense_finals = exact_closure(dev, kernels)

    with Phase("7 the gather engine (K7, K8), dual SPDs, chunked solves"):
        gather_phase(dev, kernels, dense_finals)

    with Phase("8 loose-tolerance solves (K6's dopri5 rows), pruned exact "
               "mode (K9)"):
        loose_phase(dev, kernels)

    with Phase("9 the rolled lattice rounds (K10-K13) against exact "
               "answers"):
        lattice_phase(dev, kernels)

    with Phase("10 the bit-sliced rounds (K14, K15)"):
        bits_phase(dev, kernels, main_ref)
        del main_ref

    with Phase("11 the BFF interpreter (K16-K18)"):
        bff_phase(dev, kernels, bff_units)

    with Phase("12 the weighted frontier (K19-K22, K11's tempered rounds)"):
        frontier_phase(dev, kernels)

    with Phase("13 thermodynamics (K23, K24) and the host instruments"):
        thermo_phase(dev, kernels, machines)

    with Phase("14 forward-mode derivatives (K25, K26, K6's Kvaerno rows)"):
        deriv_phase(dev, kernels)

    with Phase("15 the companion simulators (K27, K28, K29)"):
        companions_phase(dev, kernels)

    with Phase("16 reverse-mode derivatives (K30, K6's adjoint rows)"):
        reverse_phase(dev, kernels)

    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
