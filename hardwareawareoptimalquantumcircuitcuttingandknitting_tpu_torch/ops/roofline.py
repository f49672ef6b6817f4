"""Analytic performance model (roofline) for the serving engines.

The exact engines are *bandwidth-bound*: a k-qubit fused block applied to
a ``[2, 2^m]`` real-rep state moves ``2^m * 16`` bytes (read + write the
f32 state once) while doing ``~2^(m+k+4)`` flops — arithmetic intensity
``2^k`` flops/byte (8 at the k=3 fusion cap), far below an H100's ridge
point (~20 f32 flops/byte outside the tensor cores: 67 TFLOP/s over
3.35 TB/s).  The serving light-speed is therefore ``total device-memory
bytes / bandwidth``, and this module computes the bytes by walking the
engines' REAL execution plans (the lazy-width step list ``make_sim_fn``
attaches to its closure — not a re-derivation), so lazy qubit
introduction, host-shared prefixes, fused block widths and the knit
contraction are all accounted.

Port of the JAX package's ``ops/roofline.py``: the byte and flop counts
walk this package's ``variant_engine.make_sim_fn`` plan with the JAX
package's rules and equal its counts for the same circuit.  The peaks
are an H100's data-sheet numbers (:data:`H100_HBM_BYTES_PER_S`,
:data:`H100_NVLINK_BYTES_PER_S`), the ``seconds()`` defaults.  Where the
JAX package models a sampled kernel row as VMEM-resident at every width,
this package's kernels keep the state on chip only up to
:data:`~.variant_kernel.CLUSTER_QUBITS` simulated qubits (one CTA, or a
two-CTA cluster);
wider states live in global memory and their passes count.

The reference has no performance model at all (its hot loop is a z3
solve plus Aer jobs).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..virt.virtual_circuit import VirtualCircuit
from .variant_kernel import CLUSTER_QUBITS

# H100 SXM5 80GB HBM3 memory bandwidth, bytes/s (NVIDIA data sheet:
# 3.35 TB/s).
H100_HBM_BYTES_PER_S = 3.35e12
# H100 NVLink 4 bandwidth one way, bytes/s (NVIDIA data sheet: 900 GB/s
# both ways).  The pair exchange sends one direction per step, so the
# model charges one direction.
H100_NVLINK_BYTES_PER_S = 450e9
_STATE_BYTES = 8  # [2] real-rep axis x f32


@dataclass
class FragmentCost:
    name: str
    num_variants: int
    sim_qubits: int          # full width (incl. deferral ancillas)
    prefix_width: int        # qubits simulated once on the host
    steps: int               # per-variant plan steps (blocks + slots + ins)
    bytes_per_variant: int   # HBM bytes for one variant's simulation
    flops_per_variant: int
    width_histogram: dict = field(default_factory=dict)  # width -> #passes

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_variant * self.num_variants

    @property
    def total_flops(self) -> int:
        return self.flops_per_variant * self.num_variants


def fragment_cost(virt: VirtualCircuit, frag_name: str) -> FragmentCost:
    """Walk one fragment's real per-variant execution plan and count HBM
    traffic and flops.  Counting rules (one einsum per plan step —
    ops/statevector.apply_matrix):

      * gate/slot step at width m: read + write the state once
        (``2^m * 16`` bytes); flops ``2 * (2*2^k)^2 * 2^(m-k)`` for a
        k-qubit block (real-rep matmul over 2^(m-k) groups);
      * ``ins`` (lazy qubit introduction) at width m: read ``2^m``,
        write ``2^(m+1)`` amplitudes;
      * finish: |psi|^2 (read 2^m, write 2^(m-1) reals) plus the
        pairwise marginalisation cascade (geometric, <= 2x the first
        pass) down to the written-clbit marginal.
    """
    from .variant_engine import label_strides, make_sim_fn

    prog = virt.programs[frag_name]
    specs = [vg.spec for vg in virt.vgates]
    _, _, num_variants = label_strides(specs, prog.touching)
    # model the production plan: fused slot triples (one pass/endpoint)
    sim_one, _, positions, _ = make_sim_fn(
        virt, frag_name, build_matrices=False, fused_slots=True
    )

    m = sim_one.prefix_width
    bytes_v = 0
    flops_v = 0
    hist: dict[int, int] = {}
    for stp in sim_one.run_plan:
        kind = stp[0]
        if kind == "ins":
            bytes_v += (1 << m) * _STATE_BYTES          # read
            bytes_v += (1 << (m + 1)) * _STATE_BYTES    # write
            m += 1
            continue
        if kind == "pauli":
            continue  # exact path: noise steps are no-ops
        k = len(stp[2])
        bytes_v += 2 * (1 << m) * _STATE_BYTES          # read + write
        flops_v += 2 * (2 << k) * (2 << k) * (1 << max(0, m - k))
        hist[m] = hist.get(m, 0) + 1
    # |psi|^2 + marginalisation cascade (sum of halving passes <= 2x)
    bytes_v += (1 << m) * _STATE_BYTES + (1 << max(0, m - 1)) * 4
    bytes_v += 2 * (1 << m) * 4

    return FragmentCost(
        name=frag_name,
        num_variants=num_variants,
        sim_qubits=prog.num_sim_qubits,
        prefix_width=sim_one.prefix_width,
        steps=len(sim_one.run_plan),
        bytes_per_variant=int(bytes_v),
        flops_per_variant=int(flops_v),
        width_histogram=hist,
    )


@dataclass
class StepModel:
    fragments: list
    knit_bytes: int
    total_bytes: int
    total_flops: int
    global_labels: int
    n_chunks: int
    carry_elems: int

    def seconds(self, bandwidth: float = H100_HBM_BYTES_PER_S) -> float:
        """Light-speed steady-step time at the given memory bandwidth."""
        return self.total_bytes / bandwidth

    @property
    def flops_per_byte(self) -> float:
        return self.total_flops / max(1, self.total_bytes)


def streamed_step_model(virt: VirtualCircuit, chunk: int = 512,
                        keep_clbits=None,
                        share_prefix: bool = False,
                        hoist_banks: bool = False) -> StepModel:
    """Cost model for one steady ``make_streamed_knit`` step: every
    fragment's full variant fan-out plus the per-chunk fold/outer-product
    accumulation into the carry.

    The per-fragment variant count here is each fragment's own label
    space; the streamed scan enumerates GLOBAL labels, so fragments not
    touching every vgate simulate duplicate rows — modelled faithfully
    (global_labels per fragment), matching what the scan executes.

    ``share_prefix=True`` models the tree-shared engine: per fragment the
    same :func:`~.variant_engine.split_plan` the engine uses decides the
    ancestor-bank split, and the same :func:`~.variant_engine.
    suffix_stages` ladder decides the in-chunk group dedup — bank rows
    are gathered once per ``r_anc`` labels and each suffix stage's
    segment runs once per ``r_out`` labels (exactly what the staged
    executor in ops/streamed.py does for this ``chunk``).
    """
    import math

    from .variant_engine import (
        _steps_hbm_bytes,
        label_strides,
        make_sim_fn,
        split_plan,
        suffix_stages,
    )

    frags = [fragment_cost(virt, r.name) for r in virt.fragments]
    total_labels = 1
    for vg in virt.vgates:
        total_labels *= vg.spec.num_instantiations
    n_chunks = max(1, math.ceil(total_labels / chunk))

    total_bytes = 0
    total_flops = 0
    carry_elems = 1
    read_rows = 0
    for fc, reg in zip(frags, virt.fragments):
        shared_bytes = None
        if share_prefix:
            prog = virt.programs[reg.name]
            specs = [vg.spec for vg in virt.vgates]
            sim_one, _, _, _ = make_sim_fn(
                virt, reg.name, build_matrices=False, fused_slots=True
            )
            sp = split_plan(sim_one, prog, specs, total_labels,
                            hoisted=hoist_banks)
            if sp is not None:
                # staged suffix: walk the actual group ladder the engine
                # will execute at this chunk size
                gstride, _, _ = label_strides(specs, range(len(specs)))
                stages, r_anc = suffix_stages(
                    sp, prog, specs, gstride, chunk
                )
                b = (total_labels // r_anc) * (1 << (sp.m_split + 1)) * 4
                m = sp.m_split
                for st in stages:
                    seg_b, m = _steps_hbm_bytes(st.steps, st.m_in)
                    b += seg_b * (total_labels // max(1, st.r_out))
                finish = (
                    (1 << m) * _STATE_BYTES
                    + (1 << max(0, m - 1)) * 4 + 2 * (1 << m) * 4
                )
                b += finish * total_labels
                if not hoist_banks:
                    b += sp.build_bytes
                shared_bytes = b
        # the scan simulates every GLOBAL label (duplicates included)
        total_bytes += (
            shared_bytes if shared_bytes is not None
            else fc.bytes_per_variant * total_labels
        )
        total_flops += fc.flops_per_variant * total_labels
        prog = virt.programs[reg.name]
        m_bits = len(prog.clbit_sources)
        data_bits = sum(
            1 for c in prog.clbit_sources
            if c < virt.num_clbits
            and (keep_clbits is None or c in keep_clbits)
        )
        # weight folds: one read+write of the [chunk, 2^bits] rows per
        # touching vgate (bits shrink as measure bits are consumed);
        # bounded above by #folds passes at the full row width
        fold_passes = len(prog.touching) + (m_bits - data_bits)
        total_bytes += fold_passes * 2 * total_labels * (1 << m_bits) * 4
        read_rows += total_labels * (1 << data_bits) * 4
        carry_elems *= 1 << data_bits

    # cross-fragment outer product: read each fragment's folded rows once
    # per chunk, accumulate into the carry (read+write per chunk)
    knit_bytes = read_rows + n_chunks * 2 * carry_elems * 4
    total_bytes += knit_bytes

    return StepModel(
        fragments=frags,
        knit_bytes=int(knit_bytes),
        total_bytes=int(total_bytes),
        total_flops=int(total_flops),
        global_labels=total_labels,
        n_chunks=n_chunks,
        carry_elems=int(carry_elems),
    )


# ---------------------------------------------------------------------------
# NVLink (card-to-card) roofline for the sharded engines
# ---------------------------------------------------------------------------

@dataclass
class ShardedCost:
    """Per-STEP communication + local-HBM model of a sharded execution.

    All byte counts are PER DEVICE for one full steady step (every
    variant on that device).  ``ici_bytes`` (the JAX package's field
    name) counts the NVLink bytes of the pair exchanges SENT (one
    direction — the exchange is symmetric) plus the
    marginal's psum modelled as a ring all-reduce
    (``2 * (amp-1)/amp * payload``); ``hbm_bytes`` counts local block
    passes with the same rules as :func:`fragment_cost` at the local
    width.  The predicted step time is the max of the two rooflines
    (they overlap: the pair exchange is asynchronous).
    """

    name: str
    dp: int
    amp: int
    num_variants: int            # global variant count (padded)
    variants_per_device: int
    local_width: int             # 2^(n-k) amplitudes per device
    n_ppermute: int              # ppermute ops per variant
    ici_bytes: int               # NVLink, per device, one way, full step
    hbm_bytes: int               # per device, full step
    psum_bytes: int              # included in ici_bytes (reported apart)

    def seconds(self, hbm_bw: float = H100_HBM_BYTES_PER_S,
                ici_bw: float = H100_NVLINK_BYTES_PER_S) -> float:
        return max(self.hbm_bytes / hbm_bw, self.ici_bytes / ici_bw)

    @property
    def comm_fraction(self) -> float:
        """NVLink bytes / (NVLink + HBM) — how communication-bound the
        step is at equal bandwidths (scale by the bandwidth ratio for a
        device)."""
        return self.ici_bytes / max(1, self.ici_bytes + self.hbm_bytes)


def _sharded_op_counts(prog_ops, k: int):
    """(n_ppermute_per_variant, ppermute_payload_blocks, hbm_passes)
    for one variant's suffix ops at ``2^k`` amplitude shards — mirrors
    ShardCtx.apply's dispatch exactly (ops/sharded_sv.py):

      * local gate (all axes >= k): 0 ppermutes, 2 local passes;
      * 1q global / 2q mixed: 1 ppermute of the local block
        (payload 1 block), 3 local passes (state r/w + partner read);
      * 2q global: 2 ppermutes (1 block + the 2-stack -> 3 blocks),
        6 local passes (state r/w + p2 + stacked r/w as 2 blocks).
    """
    n_pp = 0
    blocks = 0
    passes = 0
    for op in prog_ops:
        # fused_stream skeleton "u" entries are ("u", axes); slot/raw
        # entries are (kind, payload, axes) — axes is always last
        axes = op[-1]
        if all(q >= k for q in axes):
            passes += 2
        elif len(axes) == 1 or any(q >= k for q in axes):
            n_pp += 1
            blocks += 1
            passes += 3
        else:
            n_pp += 2
            blocks += 3
            passes += 6
    return n_pp, blocks, passes


def sharded_fragment_cost(
    virt: VirtualCircuit, frag_name: str, dp: int, amp: int,
    dtype_bytes: int = 4,
) -> ShardedCost:
    """NVLink + HBM model of one ``run_fragment_sharded`` step on a
    ``(dp, amp)`` mesh — walks the SAME fused op stream the engine
    builds (ops/sharded_fragment.make_sharded_fragment_fn), splitting it
    at the first slot into the once-per-call prefix and the per-variant
    suffix.  ``dtype_bytes=2`` models the bf16 serving mode (ppermute
    payloads AND local passes halve; the psum stays f32)."""
    import math

    from .fusion import fused_stream
    from .variant_engine import label_strides

    prog = virt.programs[frag_name]
    specs = [vg.spec for vg in virt.vgates]
    _, _, flat_count = label_strides(specs, prog.touching)
    padded = -(-flat_count // dp) * dp
    v_dev = padded // dp

    k = int(math.log2(amp))
    assert 1 << k == amp, "amp must be a power of 2"
    n = prog.num_sim_qubits
    local_width = n - k
    block_bytes = 2 * (1 << local_width) * dtype_bytes

    skeleton, _mats = fused_stream(prog.ops)
    first_slot = next(
        (i for i, op in enumerate(skeleton)
         if op[0] not in ("u", "u_aux")),
        len(skeleton),
    )
    pre_pp, pre_blocks, pre_passes = _sharded_op_counts(
        skeleton[:first_slot], k
    )
    suf_pp, suf_blocks, suf_passes = _sharded_op_counts(
        skeleton[first_slot:], k
    )

    # marginal: |psi|^2 pass + psum of the [2^m] scatter (f32), per
    # variant; ring all-reduce moves 2*(amp-1)/amp * payload per device
    m_bits = len(prog.clbit_sources)
    psum_payload = (1 << m_bits) * 4
    psum_dev = int(2 * (amp - 1) / amp * psum_payload) * v_dev

    ici = (pre_blocks + v_dev * suf_blocks) * block_bytes + psum_dev
    hbm = (
        (pre_passes + v_dev * suf_passes) * block_bytes
        + v_dev * (block_bytes + psum_payload)  # |psi|^2 + scatter
    )
    return ShardedCost(
        name=frag_name, dp=dp, amp=amp,
        num_variants=padded, variants_per_device=v_dev,
        local_width=local_width,
        n_ppermute=pre_pp + v_dev * suf_pp,
        ici_bytes=int(ici), hbm_bytes=int(hbm), psum_bytes=int(psum_dev),
    )


def sharded_sv_cost(compiled, amp: int, keep_bits: int,
                    dtype_bytes: int = 4) -> ShardedCost:
    """NVLink + HBM model of one amplitude-sharded UNCUT simulation step
    (ops/sharded_sv.make_sharded_sim): same dispatch rules over the
    compiled circuit's static gate stream, one 'variant'."""
    import math

    k = int(math.log2(amp))
    assert 1 << k == amp
    n = compiled.num_sim_qubits
    block_bytes = 2 * (1 << (n - k)) * dtype_bytes
    ops = [("u", u, axes) for (u, axes) in compiled.ops]
    n_pp, blocks, passes = _sharded_op_counts(ops, k)
    psum_payload = (1 << keep_bits) * 4
    psum_dev = int(2 * (amp - 1) / amp * psum_payload)
    return ShardedCost(
        name=getattr(compiled, "name", "circuit"), dp=1, amp=amp,
        num_variants=1, variants_per_device=1, local_width=n - k,
        n_ppermute=n_pp,
        ici_bytes=int(blocks * block_bytes + psum_dev),
        hbm_bytes=int(passes * block_bytes + block_bytes + psum_payload),
        psum_bytes=int(psum_dev),
    )


# ---------------------------------------------------------------------------
# Sampled-engine (collapse-mode) roofline — VERDICT r4 action #6
# ---------------------------------------------------------------------------

@dataclass
class SampledCost:
    """HBM model of one sampled-engine estimate (ops/qpd_sampling's
    blocked scan): per-ROW simulation cost for each fragment plus the
    einsum combine into the ``out_w``-wide carry.

    ``rows`` is the number of unique-label rows the scan actually
    executes (after collapse-mode per-sample expansion — NOT the sample
    count: duplicates are deduplicated and measuring labels replicated,
    see ops/qpd_sampling._expand_measuring_counts).

    Two regimes per fragment:
      * the collapse rows without a kernel: the state streams through
        HBM — gate passes at the lazy width, 3 passes per in-sim collapse site
        (branch-prob reduce + projector-rescale read/write), |psi|^2,
        the per-touching-vgate fold multiplies and the marginalisation
        cascade (same rules as :func:`fragment_cost`);
      * the kernels (``pallas=True``): up to ``CLUSTER_QUBITS``
        simulated qubits the state stays on chip — device-memory traffic
        collapses to the per-row OUTPUT write (the marginal / data row)
        plus the label/u inputs, and ``seconds()`` is a FLOOR, not a
        prediction; a wider state lives in global memory, so its passes
        (the rules of the rows without a kernel up to ``|psi|^2``) count
        as well.
    """

    fragments: list              # (name, rows_width_bits, bytes_per_row)
    rows: int
    out_w: int
    combine_bytes: int
    total_bytes: int
    second_moment: bool

    def seconds(self, bandwidth: float = H100_HBM_BYTES_PER_S) -> float:
        return self.total_bytes / bandwidth


def sampled_collapse_row_cost(
    virt: VirtualCircuit, frag_name: str, keep_clbits=None,
    collapse: bool = True, pallas: bool = False,
) -> tuple[int, int]:
    """(bytes_per_row, kept_width_bits) for one fragment's per-label row
    through the collapse-mode row function (ops/qpd_sampling.
    _collapse_row_builder; ``collapse=False`` models the ancilla-path
    one) — walks the SAME run_plan that function executes."""
    from .variant_engine import make_sim_fn

    prog = virt.programs[frag_name]
    sim_one, _, positions, _ = make_sim_fn(
        virt, frag_name, build_matrices=False, collapse=collapse,
        fused_slots=not collapse,
    )
    d_bits = len(positions)
    kept = d_bits if keep_clbits is None else sum(
        1 for p in positions if p in set(keep_clbits)
    )

    def state_passes():
        m = sim_one.prefix_width
        b = 0
        for stp in sim_one.run_plan:
            kind = stp[0]
            if kind == "ins":
                b += (1 << m) * _STATE_BYTES
                b += (1 << (m + 1)) * _STATE_BYTES
                m += 1
            elif kind == "collapse":
                # branch-probability reduce (read) + projector-rescale
                # (read + write)
                b += 3 * (1 << m) * _STATE_BYTES
            elif kind == "pauli":
                continue
            else:
                b += 2 * (1 << m) * _STATE_BYTES
        return b, m

    if pallas:
        # on chip: inputs (label ints + u/cscal scalars) + the output
        # row; the marginal kernel writes 2^kept, the dense one 2^d_bits.
        # Past the on-chip width the state's passes and its |psi|^2 read
        # go through global memory too.
        n_sites = len(getattr(sim_one, "collapse_slots", ()))
        in_bytes = 4 * (len(virt.vgates) + 4 * max(1, n_sites))
        bytes_r = in_bytes + (1 << kept) * 4
        if len(sim_one.active_final) > CLUSTER_QUBITS:
            passes, m = state_passes()
            bytes_r += passes + (1 << m) * _STATE_BYTES
        return int(bytes_r), kept

    bytes_r, m = state_passes()
    # |psi|^2: read state, write f32 probability row
    bytes_r += (1 << m) * _STATE_BYTES + (1 << m) * 4
    # per-touching-vgate fold multiplies on the [2^d] row (the row function
    # applies one row multiply per touching vgate)
    bytes_r += len(prog.touching) * 2 * (1 << d_bits) * 4
    # marginalisation cascade down to the kept bits (halving passes)
    w = d_bits
    while w > kept:
        bytes_r += ((1 << w) + (1 << (w - 1))) * 4
        w -= 1
    return int(bytes_r), kept


def sampled_estimate_model(
    virt: VirtualCircuit, rows: int, keep_clbits=None,
    collapse="auto", pallas: bool = False,
    second_moment: bool = True,
) -> SampledCost:
    """HBM model of one full sampled estimate over ``rows`` executed
    label rows (ops/qpd_sampling._scan_core): per-fragment row
    simulation + the weighted einsum combine (read each fragment's
    kept-width rows once, accumulate the carry; doubled when the
    second-moment/stderr pass is on, which squares the same rows)."""
    from .qpd_sampling import _collapse_flags

    flags = _collapse_flags(virt, collapse)
    frags = []
    total = 0
    out_bits = 0
    for fi, reg in enumerate(virt.fragments):
        b, kept = sampled_collapse_row_cost(
            virt, reg.name, keep_clbits=keep_clbits,
            collapse=flags[fi], pallas=pallas,
        )
        frags.append((reg.name, kept, b))
        total += b * rows
        out_bits += kept
    out_w = 1 << out_bits
    # combine: read each fragment's [rows, 2^kept] block (twice with the
    # second moment: values and their squares) + carry read/write per
    # block (bounded by rows * out_w when blocks are small — count the
    # row reads, the dominant term)
    passes = 2 if second_moment else 1
    combine = passes * sum(rows * (1 << kept) * 4 for _, kept, _ in frags)
    total += combine
    return SampledCost(
        fragments=frags, rows=rows, out_w=out_w,
        combine_bytes=int(combine), total_bytes=int(total),
        second_moment=second_moment,
    )
