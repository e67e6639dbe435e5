#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi); fail without CUDA; the
     32-bit integer peak (64 logic results a clock per SM at the maximum SM
     clock) that integer kernels' operation bounds use;
  2. build the CUDA kernels from the sources in this checkout;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, timed beside its bound: diagonal-parity encode and scrub over a
     full phi3-mini fp32 arena (3.8e9 words) with planted single data-bit,
     single parity-word and double errors, the 3-copy shared-parity scrub
     of quarter arenas, and of three full copies (1.15e10 words, the
     one-shot ecc+tmr launch; the plain version checks a gathered copy of
     the corrupted blocks and every other block must be untouched); the
     same three-full-copy check for the Hsiao scrub with corrections
     dropped (the hsiao+tmr launch; single data-bit, check-bit and
     same-word double errors, the doubles left as they are); the encodes
     at a page refresh's shape and the Hsiao scrub at a server pool copy's
     and a page repair's; the fused inject+scrub over the server pool
     (these shapes by device times of CUDA-graph replays, per-call times
     beside them); the TMR vote over token ids and the
     phi3-mini KV cache; flash attention at the one-shot prefill shape (B=4,
     H=32, S=256, hd=96, bf16), at the server's admission shape (B=1) and a
     GQA + sliding-window shape, with SDPA timed beside (flash times are
     device times of CUDA-graph replays; per-call times beside them).
     Integer kernels must match bit for bit, flash within |kernel - plain|
     <= 1e-2 + 1e-2 |plain| (bf16 rounding of the output and of P);
  4. the main path: phi3-mini-3.8b at full width and depth, random init on a
     seeded generator, attention_impl="pallas", batch 4, prompt 256, gen 32:
     the clean `off` run, `ecc` and `ecc+tmr-parallel --vote-every 8
     --vote-cache`, both at p_bit 1e-9.  Every kernel's launch count must
     grow on the protected run, ecc_corrected > 0, ecc_uncorrectable == 0,
     every scrubbed copy equals the clean arena bit for bit and the tokens
     equal the clean run's;
  5. the server path: `python -m repro_torch.launch.serve --server` at
     full width and depth (slots 4, page_tokens 16, chunk 8, prompt bucket
     256, gen_cap 32, 8 requests of `poisson_trace(seed=0)` at 2 rps, paced
     in real time, after the reference's warmup) under `off`, `ecc` with
     the pool exposed through `PagedKVPool.inject_scrub` every tick,
     `hsiao-wb` with the pool corrupted every tick and scrubbed every 4
     ticks, and `hsiao+tmr-parallel`, weights at p_bit 1e-9.  Every
     request's tokens must equal the `off` run's, corrections > 0 (read
     corrections under `hsiao-wb`), uncorrectable 0, vote disagreements 0;
     and a request joining a live `hsiao-wb` batch must equal the same
     request served alone (tokens and counters).  Before it, the Hsiao
     encode and scrub over the full arena and the fused inject+scrub over
     the full-width server pool, each against its plain version;
  6. a small-input reference: the phi3 smoke config in float32 through the
     kernels and through the plain versions must give the same tokens and
     counters and logits within 1e-4; and one smoke-width train step under
     `ecc` (weights at std 0.02) on the card against the same step on the
     CPU's plain path (loss within 1e-5, grad norm within 1e-4, the params
     within 1e-5 of their leaf's scale but for near-zero-grad elements,
     the card's parity equal to the plain encode of its params);
  7. the netlist path of the paper's Fig. 4 (run right after phase 5, before
     the launch counts are read): the 32-bit MultPIM multiplier (13,792
     gates; schedule L=320 levels of W=128, base 66) through
     `repro_torch.core.multpim` and the registry defaults.  (a) 2^20
     fault-free random products (`default_rng(42)`) must all equal
     `true_product_bits`; (b) one single-fault trial per gate
     (`default_rng(0)` operands) must corrupt exactly 12,559 of 13,792
     products (alpha 0.9106, the reference's count), and the same operands,
     fault-free, through the gate-serial `crossbar_nor` must be right;
     (c) 2^20 trials each at p_gate 1e-5 and 3e-5 and TMR with non-ideal
     voting at 3e-5: the flipped gate lanes within the binomial 99% interval
     of p x G x trials, and the closed form inside the 99% Wilson interval
     of the first 4,096 trials (for TMR, whose closed form is a word-level
     upper bound, not below it); p_hat over all trials is reported, and
     `netlist_exec`'s launches by mask mode and trial words.  Before it, in
     phase 3, both netlist kernels against their plain versions, bit for
     bit: `netlist_exec` in its three mask modes (random keep and flip)
     over 2^20 trials (also timed at the next narrower trial tile than its
     shared-memory plan takes) and over 13,792 trials, and the 64-bit
     multiplier's schedule over 2^16 trials, whose plan takes a narrower
     tile; `crossbar_nor` (levelized over its own plan) over 13,792 trials
     of the 32-bit multiplier and 2^16 trials of the 64-bit one; its row
     times the op on a CUDA gate list, with the launch from the host list
     (execute_netlist's route) and the binding alone beside it, and the
     binding's time a level beside the ASAP depth;
  8. the campaigns of the paper's Fig. 4 (bottom) and Fig. 5 (run right
     after phase 7, its launches counted apart) through
     `repro_torch.experiments` and the campaign engine: (a) the two
     multiplication and the two scaled-NN campaigns at `campaign_mc`'s
     full-mode budget (32-bit multiplier, batches of 1024, 2048 to 4096
     trials, half-width 0.02, z 2.576), each closed form inside its 99%
     Wilson interval, and the TMR point beside its upper bound; (b) the
     Fig. 5 sweep over AlexNet's weight store (62e6 words = 1,937,500
     blocks) as one batch a point, eight inject_scrub launches a point, at
     p_input 1e-4 and 5e-4: `weight_corruption_ecc(m=32)` inside the 99%
     interval, the summed corrected and uncorrectable counts beside T x
     `expected_scrub_rates`; (c) the scheme grid (`standard_grid()`, the
     kernels) batched over the same blocks at p_input 2e-4 and T 4: every
     protected scheme at most unprotected + 0.02; (d) the `fig4_nn` and
     `fig5_weights` curves and headlines at the 32-bit alpha of phase 7;
     (e) `simulate_store` over 62e6 fp32 weights at p_bit 2e-6 and 32
     scrubs: fewer corrupted weights than the unprotected copy under the
     same flips, and at most W x `weight_corruption_ecc(m=32)`.  Every
     campaign's seconds (host clock around a sync), trials a second and
     peak device memory are printed.  Before it (launches not counted),
     each kernel of the path at the campaigns' own shapes against its
     plain version, bit for bit: netlist_exec over the first batch of the
     multiplication, TMR and NN campaigns (1024 and 16,384 products);
     encode_parity, scrub and tmr_vote over the 62e6-word store and its
     three copies; inject_scrub over the first Fig. 5 interval at each
     p_input;
  9. the rest of the serve entry point (run right after phase 8, its
     launches counted apart), phi3-mini at full width and depth again from
     the same seed: (a) `--fault stuckat` and `--fault drift` one-shot under
     `ecc` and `ecc+tmr-parallel` at p 1e-9 (batch 4, prompt 256, gen 32)
     with `--mmpu-cost --mmpu-events`: tokens equal the clean run's, no
     uncorrectable block, the corrections inside the binomial 99% interval
     of the errors (stuck-at: p/2 of every copy's stored bits, since a
     defect is an error with probability 1/2 whatever the stored bit;
     drift: p), every scrubbed copy
     equal to the clean arena bit for bit, the event file's lines equal to
     n_events and the `mmpu_events` gauge; (b) `--chunk 8` under `off`,
     `ecc`, `ecc+tmr-parallel --vote-every 8` and `tmr-serial` at p_bit
     1e-9: tokens and vote counters equal to the same store's unchunked
     run, TTFT and TPOT p50/p95 printed; (c) the mMPU projection of every
     `standard_grid(include_hsiao=True)` scheme at phi3-mini's
     `StepProfile` with its event file, the ordering off < ecc < tmr-* <
     ecc+tmr and its agreement with `overhead()`, and the §V table of
     `experiments.tmr_tradeoff`; (d) the server (phase 5's 8 requests,
     submitted at once) under `hsiao-wb --adaptive-scrub`, the pool quiet
     for three served ticks and then corrupted every tick by
     `RetentionDrift(1e-8)` over dt = chunk: tokens equal phase 5's `off`
     run, no uncorrectable word, every interval inside [min, max], the
     pool-size scrub launches equal the controller's recorded schedule,
     which is printed, the interval doubled after `patience` quiet scrubs
     and halved in the storm; the schedule replayed through
     `forced_scrub_ticks` gives the same scrub ticks, tokens and counters;
     (e) a 1024 x 1024 crossbar on the card: row,
     column and partitioned gates, writes and drift at zero error equal to
     the CPU's states and cycle counts; under `StuckAtFaults(1e-4, 1e-4)`
     the pinned cells hold.  Every run prints its peak device memory;
 10. training through `repro_torch.launch.train.build` at the CLI defaults
     (batch 8 x 256 tokens of `SyntheticLM(seed=0)`, lr 3e-4, fp32 params
     and compute, TF32 off), phi3-mini at full width: (a) `--scheme ecc`,
     16 of 32 layers, 12 steps, a scrub every 4 under `TransientBitFlips(1e-9)`,
     the eval hook at step 12 (32-token prompts, 8 tokens): finite losses
     (printed with the losses of steps 1 and 12's batches under the final
     params), a short step against the final params' gradient lowering
     step 12's batch's loss, each scrub's corrections inside its binomial
     interval (99% over the run's scrubs) and their total inside its 99%
     interval, none uncorrectable, the parity after the last refresh equal
     to a fresh encode, encode launches = steps + 1 and 3 scrubs, the
     hook's tokens equal to `GenerationEngine.generate`'s; (b)
     `ecc+tmr-parallel`, 16 layers, 8 steps, the adaptive scrub from the
     injection prior at 1e-9 into all three copies: scrubs on the
     controller's schedule, no vote disagreement or uncorrectable word,
     the corrections over three copies held as in (a), copies 1 and 2
     equal to copy 0 after every refresh; (c) `hsiao --microbatches 2
     --grad-compression`, 1 layer, checkpoints every 2 steps: preempted at
     step 3, restored in a fresh loop (state and parity equal to the saved
     ones bit for bit, the scheme re-armed), a double error planted in one
     word after the step-4 checkpoint gives RESTART and a restore from
     step 4, the run ends at step 6 with finite params and its step-6 loss
     within 1e-3 of an uninterrupted run's.  Each run prints its step-time
     median, tok/s and peak device memory beside the card;
 11. the dense zoo and the MoE family (run after phase 10, its launches
     counted apart), attention_impl="pallas", random init from seed 0,
     batch 4, prompt 256, gen 32, weights at p_bit 1e-9, each config cut
     in depth only, each run's peak reckoned from phase 4's peak-to-copy
     ratios and printed before it, the measured peak after: first flash
     against its plain version (1e-2 + 1e-2 |plain|) at the phase's hd=128
     GQA shapes (B=4 and B=1 at H=32 KV=8, B=4 at H=40 KV=8), timed with
     SDPA beside; (a) phi3.5-moe-42b-a6.6b at full width (16 experts
     top-2, expert d_ff 6400), 3 of 32 layers, under `off`, `ecc` and
     `ecc+tmr-parallel --vote-every 8 --vote-cache`: the gates of phase 4,
     each path kernel launched, tok/s and the capacity drops of one
     prefill and one decode step (none at decode); (b) its server at
     phase 5's shapes under `off` and `ecc` with the pool through
     `PagedKVPool.inject_scrub` every tick: tokens equal `off`'s,
     corrections > 0, none uncorrectable; (c) qwen2.5-14b (20 of 48
     layers), nemotron-4-15b (10 of 32) and deepseek-67b (8 of 95) under
     `off` and `ecc`: `ecc` tokens equal `off`'s, corrections > 0, none
     uncorrectable, the scrubbed copy equal to the clean arena; and
     qwen2.5-14b at full depth under `off`; (d) llama4-maverick's smoke
     config (interleaved dense/MoE, top-1, the shared expert) in fp32 on
     the card against the CPU's plain path: tokens equal, logits within
     1e-4, the aux loss within 1e-6.  First of all (not counted as
     launches), the block-code and vote kernels at the phase's own
     shapes, timed beside their bounds: encode_parity and scrub over
     phi3.5-moe's and deepseek-67b's arenas, the three-copy scrub,
     tmr_vote over phi3.5-moe's KV cache, the page encode and
     inject_scrub over its pool;
 12. the SSM, hybrid, VLM and enc-dec families (run after phase 11, its
     launches counted apart), attention_impl="pallas", random init from
     seed 0 with every cross-attention gate and gate_mlp set to 1.0,
     weights at p_bit 1e-9, full width, cut in depth only where a reckoned
     peak passes 80 GB: first flash against its plain version in bf16
     (2^-7 |plain| + 2^-8 max|plain|, tight enough that one kv tile
     dropped or counted twice fails) and fp32 (2e-5 + 2e-5 |plain|) at
     head_dim 256 (B=4 S=256 H=10 KV=1, and B=1 S=3072 past the 2048
     window), at hd=128 over 1600 image tokens (non-causal, Sk != Sq, k
     and v views of one projection) and at hd=64 H=16 in the encoder's,
     decoder's and cross forms, timed with SDPA beside; (a) mamba2-130m
     (24 layers) one-shot at batch 4, prompt 2048 (8 SSD chunks), gen 32
     under `off`, `ecc` and `ecc+tmr-parallel --vote-every 8
     --vote-cache` (the vote walks the nested cache: fp32 states, conv
     tails, position), the gates of phase 4, then teacher forcing: the
     generated tokens fed back through the decode steps give `forward`'s
     logits over prompt + tokens within 1e-3 of the largest (both in
     fp32), at weights of std 0.02 and at the run's own; (b) mamba2-130m
     by `launch.train` at its defaults (batch 8 x 256, fp32) under ecc with a
     scrub every 4 of 12 steps: finite losses, a descent step, corrections
     inside their intervals; (c) recurrentgemma-2b (26 layers) one-shot
     at batch 4, prompt 256 under the three schemes, then batch 1, prompt
     3072 (the windowed flash and the 2048-slot ring) under `off` with
     teacher forcing (gated at std 0.02; at the run's own weights, where
     the RG-LRU is ill-conditioned in fp32, printed); (d)
     llama-3.2-vision-11b with (4, 1600, 4096) image embeddings, `off` at
     40 layers, `ecc` at 20, `ecc+tmr-parallel` at 10; (e)
     seamless-m4t-medium (12 + 12 layers) with (4, 256, 1024) frame
     embeddings under the three schemes; (f) three `launch.train`
     steps under ecc of recurrentgemma-2b (26 layers), llama-3.2-vision
     (5 layers: one cross block) and seamless: finite losses, and the
     grads of every stacked key finite and nonzero.  Every run prints
     tok/s, TTFT (8-step chunks), its peak and the peak reckoned from
     phase 4's (serving) or phase 10's (training) peak-to-copy ratios,
     and each run's flash launches by shape.
 13. the serving mesh (`run_mesh_path`; `tools/chip_phase.py 13`): the
     sharded scrubs against one launch, `serve --mesh 3x1` with folded TMR
     copies (`tmr-parallel` and `ecc+tmr-parallel` at 16 of 32 layers),
     `--mesh 2x2` and `1x1` one-shot (weights at std 0.02; the 2x2
     ranks split heads, ff and vocab: their fp32 logits within 1e-5 of
     one process's, their bf16 logits within twice the bf16 run alone's
     distance of the fp32 run alone's) and the 2x1 server against the
     runs alone, and the transfer guard;
 14. the training step on a mesh (`run_train_mesh_path`; `tools/
     chip_phase.py 14`, and `14d` on four cards): `make_train_step(
     param_pspecs, grad_dtype)` on four gloo ranks sharing the card --
     (a) phi3-mini at P14_DEPTH layers, fp32 compute, batch 8 x 256, two
     steps, K from the default policy clamped as the reference's
     `lower_cell` clamps it, on 2x2 then on a 4x1 mesh over the same
     ranks, (b) seamless-m4t-medium (6 + 6 layers) and llama4's smoke
     config under its bf16 policy on 2x2 and mamba2-130m (24 layers) on
     4x1, each under its rules overrides, (c) the 2x2 state saved and
     restored onto the 4x1 mesh -- and one nccl rank: (a) on 1x1 bit for
     bit, (c) the snapshot restored and stepped once.  Each run is held
     against one process on the card (the CPU tests' gates: losses, the
     first step's grads and params; replicated shards bit-identical over
     their holders; mamba2's moments a quarter of its params on every
     rank), the bf16 one process against the CPU, and the one process's
     restore against the saved leaves' digests.  It prints each rank's
     peak beside its reckoning, the step times beside one process's and
     the exchanges a step.  The step launches none of the kernels.
 15. the dry run (`repro_torch.launch.dryrun`: one rank's step on `meta`
     tensors under a memory tally and `FlopCounterMode`, its collectives
     recorded, not sent) held against the card (`run_dryrun_path`;
     `tools/chip_phase.py 15`): (a) phi3-mini's training step at 16 of 32
     layers, fp32, batch 8 x 256, K = 1, one process; (b) a one-shot
     prefill at phase 4's shape (batch 4, prompt 256) and one decode step
     after it, bf16 params at full depth: FLOPs equal to `FlopCounterMode`
     on the card's step, (a)'s argument bytes equal to its state's and
     batch's, each peak within 10% of `max_memory_allocated` after
     `reset_peak_memory_stats` (less what the process holds besides the
     step's inputs).  Inside phase 14: (c) each rank of (a)'s 2x2 world
     dry-runs its own cell (its gathers reading the peers' staging, as
     ranks sharing a card do): its exchanges (the `Exchange`'s posts plus
     its other collectives) and FLOPs equal its first step's, its peak
     within 10% (the staging halves, mapped before the step, taken out);
     (e) the same in phase 14 (d)'s four-card world (gathers allocated,
     as nccl's are).  Inside phase 13 (b): (d) the folded
     engine's generate dry-run on a 3x1 mesh beside each rank's peak,
     within 10% under `tmr-parallel`.  No kernel is launched.
 16. the keyed draws (`repro_torch.core.prng`, the reference's
     `jax.random`; `run_prng_path`; `tools/chip_phase.py 16`), from
     PRNGKey(16): (a) `bits` over 2^26 elements from 0 and from 2^32 -
     2^25 (across the 2^32 counter edge) on the card and on the CPU, equal
     to each other and to the SHA-256 digests taken from jax 0.9.0; (b)
     `bernoulli` at p 1e-9 over 2^28 draws: the reference's 37 flips at its
     positions (2^28 * 2^-23 = 32 expected, 0.27 at the nominal p); (c) a
     keyed `corrupt_store` (p_bit 1e-5) and scrub of phi3-mini's `smoke()`
     store under `ecc` and `hsiao`: the encode and scrub kernels launch,
     the counters and the read payload equal the CPU's plain route for the
     same key; (d) a keyed `materialize` of that `smoke()` model on the
     card equal to the CPU's, bit for bit.  Each
     time is printed with the card's name and power limit.
 17. experts computed where they live and the store built from block
     ranges (`run_expert_mesh_path`; `tools/chip_phase.py 17`): the keyed
     fill rate of a 2^26-word range, then (a) phi3.5-moe at full width, 3
     of 32 layers, on four gloo ranks sharing the card as 4x1 with its
     experts over data (`arch_rules(arch, extra={"expert": ("data",),
     "model_dim": ()})`), batch 4 x 256, gen 32, flash, under `off` and
     `ecc` at p_bit 1e-9: each rank builds its store from its block range
     of a keyed arena (`make_inputs(lazy=True)`), never the whole; gates:
     tokens and counters equal one process's that holds the whole batch
     and forms the same four token groups from the same key, first-step
     logits within 1e-3 of the largest (printed), corrections > 0 and
     uncorrectable 0, the largest storage each rank's build allocated
     under the whole arena's (printed).  (b) runs on four cards alone
     (`tools/chip_phase.py 17b`): llama4-maverick at full width, 2 of 48
     layers, 4x1 over nccl under its serving rules, `off` / `ecc` /
     `hsiao`, with the dry run's exchanges and generate peak, the strict
     guard and a MoE layer recomputed from whole leaves.
     (a) and phase 13 (c) also hold each `ecc` rank's generate peak
     within its parity of the `off` rank's (the dropped `off` store is
     freed: no peer maps a store's arena, `launch.placement`).
 18. heads, ff and vocab computed where they live on the serving mesh
     (`run_tensor_mesh_path`; `tools/chip_phase.py 18`): flash timed at a
     rank's new head counts; then (a) fp32 compute, gloo ranks sharing the
     card, batch 4 x 256, gen 8, flash, `off` / `ecc` at p_bit 1e-9 from a
     keyed arena of weights at std 0.02 (`TAME_STD`, the cross-checks'
     scale; 13 (c) draws its weights so too): phi3-mini at 4 layers as
     1x2 and 2x2, phi3.5-moe at 3
     of 32 layers as 2x2 with experts over data and ff over model; gates:
     tokens and counters equal one process's that serves each data
     group's rows from the same key, every step's first logits within
     1e-5 of the largest, every read of a wq / wkv / wo / w_up / w_down /
     head its 1 / model slice and nothing from that read to the next as
     large as the whole leaf, the exchanges of a generate as the dry run
     records them, the `ecc` generate peaks within the parity of `off`'s.
     (b) runs on four cards alone (`tools/chip_phase.py 18b`, nccl):
     llama4-maverick at full width, 2 of 48 layers, as 2x2 under its
     serving rules (`off` / `ecc` / `hsiao`, gen 32, bf16), counters equal
     phase 17 (b)'s, MoE layer 0 no further from its fp32 recomputation
     from whole leaves (ff slices joined) than twice the bf16
     recomputation, and phi3-mini at full width and depth as 1x4 (`ecc`),
     with the dry run's exchanges and generate peak and the reads' gates.

The second-to-last line is a JSON object of per-kernel numbers; the last is
{"ok": true, "device": {...}}.  Times are CUDA-event means on this card
(flash: of CUDA-graph replays).
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet): device
# memory rate and dense bf16 tensor-core rate.  The 32-bit integer logic
# and shift rate (64 results a clock per SM on sm_90, CUDA C++ Programming
# Guide, arithmetic instruction throughput) is set in phase 1 from the
# card's SM count and its maximum SM clock.
HBM_BYTES_S = 3.35e12
PEAK = {"bf16": 989e12}
INT32_PER_CLOCK_PER_SM = 64
#: integer instructions per word of the bit-sliced Hsiao scrub as built
#: (csrc/hsiao_secded.cu: per 32-word block a 256-instruction bit transpose,
#: 49 three-input XORs, 7 rotations and 3 ORs, rounded up to 10 a word)
HSIAO_SCRUB_OPS_PER_WORD = 10
SEED = 0


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def bound_ms(n_bytes: float, n_ops: float = 0.0, peak: str = "int32"):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import gc
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401  (the port must be in this checkout)
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 1
    from repro_torch import kernels

    dev = torch.device("cuda")
    # 1. the card
    card = setup_card(torch)

    # 2. build
    t0 = time.perf_counter()
    build_s = kernels.build()
    log(f"kernels built in {build_s:.1f}s (step {time.perf_counter() - t0:.1f}s)")

    # 3. kernels against their plain versions
    rows = {}
    rows.update(check_diag_parity(torch, dev))
    rows.update(check_hsiao(torch, dev))
    rows.update(check_inject_scrub(torch, dev))
    rows.update(check_vote(torch, dev))
    rows.update(check_flash(torch, dev))
    rows.update(check_netlist_exec(torch, dev))
    rows.update(check_crossbar_nor(torch, dev))

    # 4. the one-shot serve path, 5. the server path: each kernel's
    # launches are counted on the runs of these paths only
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_inputs
    cfg = get_config("phi3-mini-3.8b").replace(attention_impl="pallas")
    t0 = time.perf_counter()
    inputs = make_inputs(cfg, batch=4, prompt_len=256, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"{cfg.name}: random init in {time.perf_counter() - t0:.1f}s")
    launches = run_main_path(torch, cfg, inputs)
    server, server_clean = run_server_path(torch, cfg, inputs["params"])
    del inputs
    torch.cuda.empty_cache()
    # 7. the netlist path (Fig. 4)
    netlist = run_netlist_path(torch, dev)
    # 8. the campaigns (Fig. 4 bottom, Fig. 5, the scheme grid)
    campaigns = run_campaign_path(torch, dev)
    # 9. the rest of the serve entry point (faults, chunks, the cost model,
    # the adaptive scrub, the crossbar simulator)
    serve_rest = run_serve_rest_path(torch, cfg, server_clean, dev)
    # 10. training (the protected TrainLoop, launch.train)
    train = run_train_path(torch, card, dev)
    for name in ("encode_parity", "scrub", "tmr_vote", "encode_hsiao",
                 "scrub_hsiao"):
        check(train.get(name, 0) > 0, f"{name} never launched in training")
    gc.collect()
    torch.cuda.empty_cache()
    # 11. the dense zoo and the MoE family
    zoo = run_zoo_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 12. the SSM, hybrid, VLM and enc-dec families
    families = run_family_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 13. the serving mesh (its ranks' launches summed into its count)
    mesh, _ = run_mesh_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 14. the training step on a mesh (it launches none of the kernels);
    # phase 15 (c) inside it
    run_train_mesh_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 15. the dry run against the card (it launches none of the kernels)
    run_dryrun_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 16. the keyed draws (its keyed stores' launches in its count)
    keyed = run_prng_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 17. experts where they live, the store from block ranges (its ranks'
    # launches in its count; (b) needs four cards: tools/chip_phase.py 17b)
    experts = run_expert_mesh_path(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 18. heads, ff and vocab where they live (its ranks' launches in its
    # count; (b) needs four cards: tools/chip_phase.py 18b)
    tensor = run_tensor_mesh_path(torch, card, dev)
    paths = (launches, server, netlist, campaigns, serve_rest, train, zoo,
             families, mesh, keyed, experts, tensor)
    for name, row in rows.items():
        row["launches"] = sum(p.get(name, 0) for p in paths)
        check(row["launches"] > 0, f"{name} never launched on the main path")
    log("launches by path (one-shot ecc+tmr-parallel / server, 4 runs / "
        "netlist / campaigns / phase 9 / train / zoo / families / mesh / "
        "keyed / experts / tensor): "
        + ", ".join(f"{name} " + "/".join(str(p.get(name, 0)) for p in paths)
                    for name in rows))

    # 6. small-input reference
    check_small_reference(torch, dev)

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def setup_card(torch) -> str:
    """Turn TF32 off, print the card's name and power limit, set the
    32-bit integer peak from its SMs and top clock; returns the name line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    PEAK["int32"] = INT32_PER_CLOCK_PER_SM * sms * mhz * 1e6
    log(f"{sms} SMs at {mhz:.0f} MHz max: 32-bit logic and shift peak "
        f"{PEAK['int32'] / 1e12:.2f} Tops/s")
    return card


# ----------------------------------------------------------------------------
# timing helpers
# ----------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean CUDA-event time of fn() over `reps` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one fn() call: `reps` calls captured in a CUDA graph,
    the graph replayed and timed by CUDA events, so the host's launch
    overhead between calls is not counted (for kernels of microseconds,
    where back-to-back calls from Python time the host)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(4):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (4 * reps)


def timed_once(torch, fn):
    """(result, CUDA-event ms) of one call."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def small_shape_ms(torch, fn):
    """(device ms by CUDA-graph replay, ms per call from Python by CUDA
    events around back-to-back calls) of a short launch (microseconds to
    a millisecond), where the per-call figure times the host's enqueue as
    much as the card and moves from one call to the next."""
    return graph_ms(torch, fn), time_ms(torch, fn, reps=20)


def row(name, source, replaces, ms, plain_ms, bound, err, library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def random_word_chunks(torch, n: int, g, dev):
    """(start, end, words) chunks of n uniformly random 32-bit words
    (int32 storage), drawn in order from `g`."""
    step = 1 << 28
    for i in range(0, n, step):
        j = min(n, i + step)
        yield i, j, torch.randint(-2**31, 2**31, (j - i,), dtype=torch.int64,
                                  device=dev, generator=g).to(torch.int32)


def random_words(torch, n: int, g, dev):
    """n uniformly random 32-bit words (int32 storage), drawn in chunks."""
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for i, j, chunk in random_word_chunks(torch, n, g, dev):
        out[i:j] = chunk
    return out


def server_spec():
    """The server path's batch shape (phase 5)."""
    from repro_torch.launch.batching import BatchSpec
    return BatchSpec(slots=4, page_tokens=16, chunk=8, prompt_buckets=(256,),
                     gen_cap=32)


def server_pool_words(cfg=None):
    """(words of one server pool copy, words of one tick's page refresh:
    16 page rows, four slots x two pages x the k and v planes) of `cfg`
    (default phi3-mini)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.batching import PagedKVPool
    pool = PagedKVPool(cfg or get_config("phi3-mini-3.8b"), server_spec(),
                       copies=False, device="meta")
    return pool.arena_spec.n_words, 16 * pool.page_words


def distinct_ints(torch, hi: int, k: int, g):
    """k distinct uniform ints below hi >> k, in random order, on g's
    device (a randperm of hi would sort hi keys: gigabytes beside an
    arena's copies)."""
    x = torch.unique(torch.randint(0, hi, (2 * k,), device=g.device,
                                   generator=g))
    check(x.numel() >= k, "too few distinct draws")
    return x[torch.randperm(x.numel(), device=g.device, generator=g)[:k]]


def flip_bits(torch, words, idx, bit):
    """words[idx] ^= 1 << bit (distinct idx), in place."""
    words[idx] ^= (torch.ones_like(bit) << bit).to(torch.int32)


# ----------------------------------------------------------------------------
# 3. kernels vs plain versions
# ----------------------------------------------------------------------------

def check_diag_parity(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import diag_parity as D
    from repro_torch.models import transformer as T
    from repro_torch.models.params import layout

    cfg = get_config("phi3-mini-3.8b")
    spec = layout(T.model_specs(cfg), cfg.param_dtype)
    n, nb = spec.n_words, spec.n_blocks
    g = torch.Generator(device=dev).manual_seed(SEED)
    words = random_words(torch, n, g, dev)
    log(f"diag_parity: phi3-mini arena {n} words ({n * 4 / 1e9:.2f} GB), "
        f"{nb} blocks")

    parity = D.encode_parity(words)
    plain, enc_plain_ms = timed_once(torch, lambda: D.encode_parity_ref(words))
    check(torch.equal(parity, plain), "encode kernel != plain version")
    del plain
    enc_ms = time_ms(torch, lambda: D.encode_parity(words))
    enc_bound = bound_ms(n * 4 + nb * 12, 6 * n)
    log(f"encode_parity: kernel {enc_ms:.3f} ms, plain {enc_plain_ms:.1f} ms, "
        f"bound {enc_bound[0]:.3f} ms ({enc_bound[1]}); bit-exact")
    _, npage = server_pool_words()
    page = words[:npage]
    page_ms, page_call_ms = small_shape_ms(torch, lambda: D.encode_parity(page))
    page_plain_ms = time_ms(torch, lambda: D.encode_parity_ref(page), reps=3)
    log(f"encode_parity (a page refresh, {npage} words): kernel "
        f"{page_ms:.4f} ms (per call {page_call_ms:.4f}), plain "
        f"{page_plain_ms:.4f} ms, bound "
        f"{bound_ms(npage * 4 + npage // 32 * 12, 6 * npage)[0]:.4f} ms")
    del page                          # a view: it would keep the arena

    # plant 1000 single data-bit errors, 100 single parity-word errors and
    # 100 double errors, each in its own block
    blocks = torch.randperm(nb, device=dev, generator=g)[:1200]
    single, pblk, double = blocks[:1000], blocks[1000:1100], blocks[1100:]

    def rint(hi, k):
        return torch.randint(0, hi, (k,), device=dev, generator=g)

    flip_bits(torch, words, single * 32 + rint(32, 1000), rint(32, 1000))
    i1 = rint(32, 100)
    i2 = (i1 + 1 + rint(31, 100)) % 32
    d_idx = torch.cat([double * 32 + i1, double * 32 + i2])
    d_bit = rint(32, 200)
    flip_bits(torch, words, d_idx, d_bit)
    bad_par = parity.clone()
    flip_bits(torch, bad_par.view(-1), pblk * 3 + rint(3, 100), rint(32, 100))

    words_p, bad_par_p = words.clone(), bad_par.clone()
    counts = D.scrub(words, bad_par)[2]
    counts_p, scrub_plain_ms = timed_once(
        torch, lambda: D.scrub_ref(words_p, bad_par_p)[2])
    check(torch.equal(words, words_p) and torch.equal(bad_par, bad_par_p)
          and torch.equal(counts, counts_p), "scrub kernel != plain version")
    check(counts.tolist() == [1000, 100, 100],
          f"scrub counts {counts.tolist()} != planted [1000, 100, 100]")
    del words_p, bad_par_p
    flip_bits(torch, words, d_idx, d_bit)      # undo the uncorrectable pairs
    check(torch.equal(bad_par, parity), "parity words not healed")
    check(torch.equal(D.encode_parity(words), parity),
          "scrubbed arena does not re-encode to the clean parity")
    scrub_ms = time_ms(torch, lambda: D.scrub(words, parity))
    scrub_bound = bound_ms(n * 4 + nb * 12 + (1000 + 100) * 4, 8 * n)
    log(f"scrub: kernel {scrub_ms:.3f} ms (clean arena), plain "
        f"{scrub_plain_ms:.1f} ms, bound {scrub_bound[0]:.3f} ms; counts "
        f"{counts.tolist()} bit-exact")
    del words, parity, bad_par
    torch.cuda.empty_cache()

    # three stacked copies of a quarter arena against one shared table, the
    # engine's Compose layout (parity row b mod n_blocks, corrections dropped)
    nq = (n // 4) // 32 * 32
    base = random_words(torch, nq, g, dev)
    par = D.encode_parity(base)
    w3 = base.repeat(3)
    idx = torch.randperm(3 * nq // 32, device=dev, generator=g)[:3000] * 32 \
        + rint(32, 3000)
    flip_bits(torch, w3, idx, rint(32, 3000))
    w3_p = w3.clone()
    _, none_p, c3 = D.scrub(w3, par)
    _, _, c3_p = D.scrub_ref(w3_p, par)
    check(none_p is None and torch.equal(w3, w3_p) and torch.equal(c3, c3_p),
          "shared-parity scrub kernel != plain version")
    check(c3.tolist() == [3000, 0, 0]
          and all(torch.equal(r, base) for r in w3.view(3, nq)),
          f"shared-parity scrub counts {c3.tolist()}")
    shared_ms = time_ms(torch, lambda: D.scrub(w3, par))
    log(f"scrub (3 copies x {nq} words, shared parity): kernel "
        f"{shared_ms:.3f} ms, bound "
        f"{bound_ms(3 * nq * 4 + nq // 32 * 12)[0]:.3f} ms; bit-exact")
    del base, par, w3, w3_p
    torch.cuda.empty_cache()
    check_scrub_three_copies(torch, dev, n, g, "diag")

    src = "src/repro_torch/kernels/csrc/diag_parity.cu"
    return {
        "encode_parity": row("encode_parity", src,
                             "src/repro/kernels/diag_parity/kernel.py:48",
                             enc_ms, enc_plain_ms, enc_bound, 0.0),
        "scrub": row("scrub", src,
                     "src/repro/kernels/diag_parity/kernel.py:130",
                     scrub_ms, scrub_plain_ms, scrub_bound, 0.0),
    }


def check_scrub_three_copies(torch, dev, n, g, code):
    """The launch a protected TMR scheme makes at prepare time: three
    stacked full arena copies (1.15e10 words) against one shared table,
    bit-exact against the plain version.  `code` is "diag" (the one-shot
    ecc+tmr launch; the check also writes every copy's corrected rows) or
    "hsiao" (hsiao+tmr: corrections dropped, as launch/engine.py launches
    it).  The three copies leave no room for a second set, so the plain
    version scrubs a gathered copy of the corrupted blocks (the codes are
    block-local), and every other block must come out as it went in: the
    clean arena is drawn again from its seed, chunk by chunk, to compare.
    Then the clean launch is timed."""
    from repro_torch.kernels import diag_parity as D
    from repro_torch.kernels import hsiao_secded as H
    hsiao = code == "hsiao"
    name, encode, scrub, scrub_ref, ops_per_word = (
        ("scrub_hsiao", H.encode_hsiao, H.scrub, H.scrub_hsiao_ref,
         HSIAO_SCRUB_OPS_PER_WORD) if hsiao else
        ("scrub", D.encode_parity, D.scrub, D.scrub_ref, 8))
    nb = n // 32
    torch.cuda.reset_peak_memory_stats()

    def rint(hi, k):
        return torch.randint(0, hi, (k,), device=dev, generator=g)

    def arena_gen():
        return torch.Generator(device=dev).manual_seed(SEED + 8)

    w3 = torch.empty(3 * n, dtype=torch.int32, device=dev)
    for i, j, chunk in random_word_chunks(torch, n, arena_gen(), dev):
        w3[i:j] = chunk
    w3[n:2 * n] = w3[:n]
    w3[2 * n:] = w3[:n]
    par = encode(w3[:n])
    rows = par.shape[1]
    # 3000 single data-bit flips and 300 doubles over the copies (two words
    # of a block for the diagonal code, two bits of one word for Hsiao: both
    # detected, and Hsiao's must be left as they are), and 100 single-bit
    # errors in the shared table (every copy sees them)
    blk = distinct_ints(torch, 3 * nb, 3300, g)
    prow = distinct_ints(torch, nb, 100, g)
    hit = torch.unique(torch.cat([blk, prow, prow + nb, prow + 2 * nb]))
    w3v = w3.view(-1, 32)
    clean_rows = w3v[hit].clone()
    i1, b1 = rint(32, 3300), rint(32, 3300)
    flip_bits(torch, w3, blk * 32 + i1, b1)
    if hsiao:
        d_idx = blk[3000:] * 32 + i1[3000:]
        flip_bits(torch, w3, d_idx, (b1[3000:] + 1 + rint(31, 300)) % 32)
        doubled = w3[d_idx].clone()
    else:
        i2 = (i1[3000:] + 1 + rint(31, 300)) % 32
        flip_bits(torch, w3, blk[3000:] * 32 + i2, rint(32, 300))
    bad_par = par.clone()
    flip_bits(torch, bad_par.view(-1), prow * rows + rint(rows, 100),
              rint(32, 100))
    small = w3v[hit].reshape(-1).clone()
    small_par = bad_par[hit % nb].clone()
    out = small_out = None
    if not hsiao:
        out = torch.empty((3 * nb, rows), dtype=torch.int32, device=dev)
        small_out = torch.empty_like(small_par)

    _, _, counts = scrub(w3, bad_par, out_parity=out)
    _, _, counts_p = scrub_ref(small, small_par, out_parity=small_out)
    same = (torch.equal(w3v[hit].reshape(-1), small)
            and torch.equal(counts, counts_p))
    if out is not None:
        same &= torch.equal(out[hit], small_out)
    check(same, f"3-copy shared-table {name} kernel != plain version")
    if hsiao:
        check(torch.equal(w3[d_idx], doubled),
              "3-copy scrub_hsiao changed a same-word double")
    del bad_par, small, small_par, small_out
    w3v[hit] = clean_rows
    copies = w3.view(3, n)
    same = True
    if out is not None:
        out[hit] = par[hit % nb]
        same = all(torch.equal(t, par) for t in out.view(3, nb, rows))
    for i, j, chunk in random_word_chunks(torch, n, arena_gen(), dev):
        same &= all(torch.equal(c[i:j], chunk) for c in copies)
    check(same, f"3-copy shared-table {name} changed a block outside the "
          f"planted ones")
    del out, copies, clean_rows
    ms = time_ms(torch, lambda: scrub(w3, par))
    bnd = bound_ms(3 * n * 4 + nb * rows * 4, ops_per_word * 3 * n)
    log(f"{name} (3 full copies x {n} words, shared table, corrections "
        f"dropped, as the {'hsiao' if hsiao else 'ecc'}+tmr launch): kernel "
        f"{ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}); counts "
        f"{counts.tolist()} ({hit.numel()} blocks hit) bit-exact"
        f"{', same-word doubles untouched' if hsiao else ''}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del par, w3, w3v
    torch.cuda.empty_cache()


def check_hsiao(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import hsiao_secded as H
    from repro_torch.models import transformer as T
    from repro_torch.models.params import layout

    cfg = get_config("phi3-mini-3.8b")
    spec = layout(T.model_specs(cfg), cfg.param_dtype)
    n, nb = spec.n_words, spec.n_blocks
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    words = random_words(torch, n, g, dev)
    log(f"hsiao: phi3-mini arena {n} words, {nb} blocks, check table "
        f"{nb * 28 / 1e9:.2f} GB")

    parity = H.encode_hsiao(words)
    plain, enc_plain_ms = timed_once(torch, lambda: H.encode_hsiao_ref(words))
    check(torch.equal(parity, plain), "encode_hsiao kernel != plain version")
    del plain
    enc_ms = time_ms(torch, lambda: H.encode_hsiao(words))
    enc_bound = bound_ms(n * 4 + nb * 28, 21 * n)
    log(f"encode_hsiao: kernel {enc_ms:.3f} ms, plain {enc_plain_ms:.1f} ms, "
        f"bound {enc_bound[0]:.3f} ms ({enc_bound[1]}); bit-exact")
    npool, npage = server_pool_words()
    page = words[:npage]
    check(torch.equal(H.encode_hsiao(page), H.encode_hsiao_ref(page)),
          "encode_hsiao kernel != plain version (a page refresh)")
    page_ms, page_call_ms = small_shape_ms(torch, lambda: H.encode_hsiao(page))
    page_plain_ms = time_ms(torch, lambda: H.encode_hsiao_ref(page), reps=3)
    log(f"encode_hsiao (a page refresh, {npage} words): kernel "
        f"{page_ms:.4f} ms (per call {page_call_ms:.4f}), plain "
        f"{page_plain_ms:.4f} ms, bound "
        f"{bound_ms(npage * 4 + npage // 32 * 28, 21 * npage)[0]:.4f} ms")
    del page                          # a view: it would keep the arena
    for what, nw in (("one server pool copy", npool),
                     ("a tick's page repair", npage)):
        w_, par_ = words[:nw], H.encode_hsiao(words[:nw])
        ms_, call_ms = small_shape_ms(torch, lambda: H.scrub(w_, par_))
        plain_ms_ = time_ms(torch, lambda: H.scrub_hsiao_ref(w_, par_),
                            reps=3)
        bnd = bound_ms(nw * 4 + nw // 32 * 28, HSIAO_SCRUB_OPS_PER_WORD * nw)
        log(f"scrub_hsiao ({what}, {nw} words): kernel {ms_:.4f} ms (per "
            f"call {call_ms:.4f}), plain {plain_ms_:.4f} ms, bound "
            f"{bnd[0]:.4f} ms")
        del w_, par_

    counts, scrub_plain_ms = hold_hsiao_scrub(torch, dev, words, parity, g,
                                              "the arena")
    scrub_ms = time_ms(torch, lambda: H.scrub(words, parity))
    scrub_bound = bound_ms(n * 4 + nb * 28 + (1000 + 100) * 4,
                           HSIAO_SCRUB_OPS_PER_WORD * n)
    log(f"scrub_hsiao: kernel {scrub_ms:.3f} ms (clean arena), plain "
        f"{scrub_plain_ms:.1f} ms, bound {scrub_bound[0]:.3f} ms; counts "
        f"{counts.tolist()} bit-exact, doubles untouched")
    del words, parity
    torch.cuda.empty_cache()

    check_scrub_three_copies(torch, dev, n, g, "hsiao")

    src = "src/repro_torch/kernels/csrc/hsiao_secded.cu"
    return {
        "encode_hsiao": row("encode_hsiao", src,
                            "src/repro/kernels/hsiao_secded/kernel.py:47",
                            enc_ms, enc_plain_ms, enc_bound, 0.0),
        "scrub_hsiao": row("scrub_hsiao", src,
                           "src/repro/kernels/hsiao_secded/kernel.py:112",
                           scrub_ms, scrub_plain_ms, scrub_bound, 0.0),
    }


def hold_hsiao_scrub(torch, dev, words, parity, g, what):
    """Plant 1000 single data-bit flips, 100 check-bit flips and 100
    same-word double flips, each in its own block (so in distinct words),
    in `words` and a copy of its clean check table `parity`; scrub them with
    the kernel and a copy with the plain version: bit for bit, the planted
    counts, the doubles left as they are.  Then undo the doubles: the table
    must be healed and the words re-encode to it.  Returns (counts, the
    plain version's ms)."""
    from repro_torch.kernels import hsiao_secded as H
    nb = parity.shape[0]
    blocks = torch.randperm(nb, device=dev, generator=g)[:1200]
    single, cblk, double = blocks[:1000], blocks[1000:1100], blocks[1100:]

    def rint(hi, k):
        return torch.randint(0, hi, (k,), device=dev, generator=g)

    flip_bits(torch, words, single * 32 + rint(32, 1000), rint(32, 1000))
    d_idx = double * 32 + rint(32, 100)
    b1 = rint(32, 100)
    b2 = (b1 + 1 + rint(31, 100)) % 32
    flip_bits(torch, words, d_idx, b1)
    flip_bits(torch, words, d_idx, b2)
    doubled = words[d_idx].clone()
    bad_par = parity.clone()
    flip_bits(torch, bad_par.view(-1), cblk * 7 + rint(7, 100), rint(32, 100))

    words_p, bad_par_p = words.clone(), bad_par.clone()
    counts = H.scrub(words, bad_par)[2]
    counts_p, plain_ms = timed_once(
        torch, lambda: H.scrub_hsiao_ref(words_p, bad_par_p)[2])
    check(torch.equal(words, words_p) and torch.equal(bad_par, bad_par_p)
          and torch.equal(counts, counts_p),
          f"scrub_hsiao kernel != plain version ({what})")
    check(counts.tolist() == [1000, 100, 100],
          f"scrub_hsiao counts {counts.tolist()} != planted [1000, 100, 100] "
          f"({what})")
    check(torch.equal(words[d_idx], doubled),
          f"a double-flip word was modified ({what}; must be detected, left "
          f"as is)")
    del words_p, bad_par_p
    flip_bits(torch, words, d_idx, b1)          # undo the doubles
    flip_bits(torch, words, d_idx, b2)
    check(torch.equal(bad_par, parity), f"check rows not healed ({what})")
    check(torch.equal(H.encode_hsiao(words), parity),
          f"scrubbed arena does not re-encode to the clean check table "
          f"({what})")
    return counts, plain_ms


def check_inject_scrub(torch, dev):
    from repro_torch.kernels import diag_parity as D
    from repro_torch.kernels.inject_scrub import (inject_scrub,
                                                  inject_scrub_ref)

    n, _ = server_pool_words()
    nb = n // 32
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rint(hi, k):
        return torch.randint(0, hi, (k,), device=dev, generator=g)

    def planted(copies):
        """Words, their clean parity, and a mask of 1000 single flips and
        100 two-word doubles per copy, each in its own block."""
        w = random_words(torch, copies * n, g, dev)
        par = D.encode_parity(w)
        k = 1100 * copies
        blocks = torch.randperm(copies * nb, device=dev, generator=g)[:k]
        w1 = rint(32, k)
        mask = torch.zeros_like(w)
        flip_bits(torch, mask, blocks * 32 + w1, rint(32, k))
        d = slice(1000 * copies, k)
        w2 = (w1[d] + 1 + rint(31, 100 * copies)) % 32
        flip_bits(torch, mask, blocks[d] * 32 + w2, rint(32, 100 * copies))
        return w, par, mask, blocks[:1000 * copies]

    log(f"inject_scrub: full-width server pool arena {n} words per copy "
        f"({n * 4 / 1e9:.3f} GB)")
    timed = {}
    for copies in (1, 3):
        w, par, mask, singles = planted(copies)
        w_p, par_p = w.clone(), par.clone()
        _, _, counts = inject_scrub(w, par, mask)
        (_, _, counts_p), plain_ms = timed_once(
            torch, lambda: inject_scrub_ref(w_p, par_p, mask))
        check(torch.equal(w, w_p) and torch.equal(par, par_p)
              and torch.equal(counts, counts_p),
              f"inject_scrub kernel != plain version ({copies} copies)")
        check(counts.tolist() == [1200 * copies, 1000 * copies, 0,
                                  100 * copies],
              f"inject_scrub counts {counts.tolist()} ({copies} copies)")
        del w_p, par_p
        # the timed pass: single flips only, all repaired, so the state
        # is the same before and after every launch
        w = random_words(torch, copies * n, g, dev)
        par = D.encode_parity(w)
        smask = torch.zeros_like(w)
        flip_bits(torch, smask, singles * 32 + rint(32, singles.numel()),
                  rint(32, singles.numel()))
        clean = w.clone()
        ms, call_ms = small_shape_ms(torch,
                                     lambda: inject_scrub(w, par, smask))
        check(torch.equal(w, clean), "single-flip exposure not repaired")
        bnd = bound_ms(2 * copies * n * 4 + copies * nb * 12,
                       10 * copies * n)
        log(f"inject_scrub ({copies} cop{'y' if copies == 1 else 'ies'}): "
            f"kernel {ms:.3f} ms (per call {call_ms:.3f}), plain "
            f"{plain_ms:.1f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}); counts "
            f"{counts.tolist()} bit-exact")
        timed[copies] = (ms, plain_ms, bnd)
        # a zero mask is the plain diagonal-parity scrub, bit for bit
        a = w.clone()
        flip_bits(torch, a, singles * 32 + rint(32, singles.numel()),
                  rint(32, singles.numel()))
        b = a.clone()
        pa, pb = par.clone(), par.clone()
        _, _, ca = inject_scrub(a, pa, torch.zeros_like(a))
        _, _, cb = D.scrub(b, pb)
        check(torch.equal(a, b) and torch.equal(pa, pb)
              and ca.tolist() == [0] + cb.tolist(),
              "inject_scrub with a zero mask != scrub")
        del w, par, mask, smask, clean, a, b, pa, pb
        torch.cuda.empty_cache()
    log("inject_scrub: zero mask == scrub kernel bit for bit (1 and 3 "
        "copies)")
    ms, plain_ms, bnd = timed[1]        # the row: one pool copy
    return {"inject_scrub": row(
        "inject_scrub", "src/repro_torch/kernels/csrc/inject_scrub.cu",
        "src/repro/kernels/inject_scrub/kernel.py:49", ms, plain_ms, bnd,
        0.0)}


def check_vote(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.tmr_vote import vote, vote_ref

    cfg = get_config("phi3-mini-3.8b")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = (cfg.n_layers, 4, 256 + 32, cfg.n_kv, cfg.head_dim)
    base = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    caches = []
    for _ in range(3):
        c = base.clone()
        bits = c.view(torch.int16).view(-1)
        idx = torch.randint(0, bits.numel(), (1 << 20,), device=dev,
                            generator=g)
        bits[idx] ^= torch.randint(1, 1 << 15, (1 << 20,), device=dev,
                                   generator=g).to(torch.int16)
        caches.append(c)
    toks = [torch.randint(0, cfg.vocab, (4, 1), dtype=torch.int32,
                          device=dev, generator=g) for _ in range(3)]
    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)

    for a, b, c in (caches, toks):
        check(torch.equal(bits(vote(a, b, c)), bits(vote_ref(a, b, c))),
              "vote kernel != plain version")
    # the token ids a folded rank votes once a generate in phase 13 (b):
    # (batch 4, 8 generated tokens) int32, three copies
    seq3 = [torch.randint(0, cfg.vocab, (4, 8), dtype=torch.int32,
                          device=dev, generator=g) for _ in range(3)]
    check(torch.equal(vote(*seq3), vote_ref(*seq3)),
          "vote kernel != plain version on token ids")
    tok_ms, tok_call = small_shape_ms(torch, lambda: vote(*seq3))
    tok_bnd = bound_ms(4 * seq3[0].numel() * 4, 5 * seq3[0].numel())
    log(f"tmr_vote: token ids (4, 8) int32 (phase 13 (b)'s vote): kernel "
        f"{tok_ms:.4f} ms (per call {tok_call:.4f}), bound "
        f"{tok_bnd[0]:.7f} ms ({tok_bnd[1]}); bit-exact")
    ms = time_ms(torch, lambda: vote(*caches), reps=20)
    plain_ms = time_ms(torch, lambda: vote_ref(*caches), reps=20)
    nbytes = base.numel() * 2
    bnd = bound_ms(4 * nbytes, 5 * base.numel() / 2)
    log(f"tmr_vote: KV cache {tuple(shape)} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bnd[0]:.3f} ms; tokens and cache "
        f"bit-exact")
    return {"tmr_vote": row("tmr_vote", "src/repro_torch/kernels/csrc/"
                            "tmr_vote.cu",
                            "src/repro/kernels/tmr_vote/kernel.py:24",
                            ms, plain_ms, bnd, 0.0)}


def check_flash(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def qkv(B, S, H, KV, hd):
        return [torch.randn((B, S, h, hd), device=dev, generator=g)
                .to(torch.bfloat16) for h in (H, KV, KV)]

    def compare(q, k, v, window):
        got = flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_ref(q, k, v, causal=True, window=window)
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= 1e-2 + 1e-2 * want.float().abs()).all()),
              f"flash kernel != plain version (max abs err "
              f"{diff.max().item():.3g})")
        return diff.max().item()

    # the one-shot prefill (B=4), a 2x2 mesh rank's prefill of its two
    # rows (phase 13 (c), B=2) and the server's admission prefill of one
    # request at the 256-token bucket (B=1).  ms: device time (graph_ms);
    # per call: CUDA events around back-to-back calls from Python
    S, H, hd = 256, 32, 96
    timed = {}
    for B in (4, 2, 1):
        q, k, v = qkv(B, S, H, H, hd)
        err = compare(q, k, v, 0)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fns = {"kernel": lambda: flash_attention(q, k, v, causal=True),
               "plain": lambda: flash_attention_ref(q, k, v, causal=True),
               "SDPA": lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, is_causal=True)}
        dev_ms = {name: graph_ms(torch, fn) for name, fn in fns.items()}
        call_ms = {name: time_ms(torch, fn, reps=20)
                   for name, fn in fns.items()}
        pairs = S * (S + 1) // 2
        bnd = bound_ms(4 * B * S * H * hd * 2, 4 * B * H * hd * pairs,
                       "bf16")
        log(f"flash_attention: B={B} S={S} H={H} hd={hd} bf16 causal: "
            + ", ".join(f"{name} {dev_ms[name]:.4f} ms (per call "
                        f"{call_ms[name]:.4f})" for name in fns)
            + f"; bound {bnd[0]:.4f} ms ({bnd[1]}); max abs err {err:.3g}")
        timed[B] = (dev_ms["kernel"], dev_ms["plain"], bnd, err,
                    dev_ms["SDPA"])
        del q, k, v, qh, kh, vh
    q2, k2, v2 = qkv(2, 512, 40, 8, 128)
    err2 = compare(q2, k2, v2, 128)
    log(f"flash_attention: GQA H=40 KV=8 hd=128 window=128 S=512: max abs "
        f"err {err2:.3g}")
    ms, plain_ms, bnd, err, lib_ms = timed[4]     # the row: B=4
    return {"flash_attention": row(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", ms, plain_ms, bnd,
        max(err, timed[1][3], err2), lib_ms)}


#: the netlist path's multiplier width, Monte Carlo trials and rates
#: (`benchmarks/campaign_mc.py` FIG4_PGATES), and the reference's
#: single-fault count of the 32-bit multiplier on `default_rng(0)` operands
N_BITS = 32
MC_TRIALS = 1 << 20
FIG4_PGATES = (1e-5, 3e-5)
SINGLE_FAULT_WRONG_32 = 12559
#: the schedule whose shared-memory plan takes a narrower trial tile
#: (8 words: 4,541 live rows), and its trials (1.4 GB of state)
NARROW_BITS = 64
NARROW_TRIALS = 1 << 16
Z99 = 2.576


def operands(torch, n: int, seed: int, dev):
    """n random N_BITS-bit operand pairs from numpy, as the reference
    scripts draw them, as int32 words on the card."""
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.integers(0, 2**N_BITS, n, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
            for _ in range(2))
    return a, b


def netlist_bound(L, W, base, tw, n_masks, n_rows_in):
    """bytes: rows [0, base) and the masks read, the level rows written;
    operations: 6 bitwise word ops a gate, + 1 a mask."""
    return bound_ms((base + (1 + n_masks) * L * W) * tw * 4 + n_rows_in * 4,
                    (6 + n_masks) * L * W * tw)


def check_netlist_modes(torch, dev, n_bits, trials, seed, narrow=False):
    """netlist_exec over the n_bits multiplier's schedule at `trials`
    trials in its three mask modes (random state, keep and flip) against
    the plain version, bit for bit, through the op; the kernel's binding
    timed at the tile the op launches and, with `narrow`, at the next
    narrower one.  Returns {mode: (ms, plain ms, bound)}."""
    from repro_torch.core import multpim, scheduler
    from repro_torch.kernels.netlist_exec import kernel, netlist_exec
    from repro_torch.kernels.netlist_exec import netlist_exec_ref
    from repro_torch.kernels.netlist_exec import plan as P

    sch = scheduler.schedule(multpim.multiplier_netlist(n_bits))
    L, W, base, tw = sch.n_levels, sch.max_width, sch.base, -(-trials // 32)
    plan = P.plan(sch.rows_in, base)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows_in = torch.as_tensor(sch.rows_in, device=dev)
    # random words everywhere (rows >= base too: the kernel overwrites them)
    state = random_words(torch, sch.n_rows * tw, g, dev).view(sch.n_rows, tw)
    masks = [random_words(torch, L * W * tw, g, dev).view(L, W, tw)
             for _ in range(2)]
    log(f"netlist_exec: {n_bits}-bit multiplier schedule L={L} W={W} "
        f"base={base}, {trials} trials, state {sch.n_rows} x {tw} words "
        f"({sch.n_rows * tw * 4 / 1e9:.2f} GB); plan {plan.n_slots} live "
        f"rows, trial tiles that fit {plan.tile(0)} / {plan.tile(1)} / "
        f"{plan.tile(2)} words (none / xor / keep+xor)")
    timed = {}
    for mode, (keep, flip) in (("none", (None, None)),
                               ("xor", (None, masks[1])),
                               ("keep+xor", tuple(masks))):
        n_masks = (flip is not None) + (keep is not None)
        got = netlist_exec(rows_in, state.clone(), keep, flip, base=base)
        plain = state.clone()
        _, plain_ms = timed_once(torch, lambda: netlist_exec_ref(
            rows_in, plain, keep, flip, base=base))
        check(torch.equal(got, plain),
              f"netlist_exec kernel != plain version ({n_bits}-bit, {mode})")
        check(torch.equal(got[:base], state[:base]),
              f"netlist_exec wrote below base ({n_bits}-bit, {mode})")
        del got, plain
        work = state.clone()
        tile = plan.tile(n_masks)
        launched = P.launch_tile(tile, tw, torch.cuda.get_device_properties(
            dev).multi_processor_count) if dev.type == "cuda" else tile

        def at(t):
            return lambda: kernel.netlist_exec(plan, t, work, keep, flip)
        ms = time_ms(torch, at(launched))
        bnd = netlist_bound(L, W, base, tw, n_masks, rows_in.numel())
        extra = ""
        if narrow and launched > 1:
            extra = (f"; at a {launched // 2}-word tile "
                     f"{time_ms(torch, at(launched // 2)):.3f} ms")
        log(f"netlist_exec ({n_bits}-bit, {trials} trials, {mode}, "
            f"{launched}-word tile): kernel {ms:.3f} ms, plain {plain_ms:.1f} "
            f"ms, bound {bnd[0]:.3f} ms ({bnd[1]}){extra}; bit-exact")
        timed[mode] = (ms, plain_ms, bnd)
        del work
    # the op's host work a launch: rows_in to the host, its plan from the
    # cache (keyed by the bytes), as at every Monte Carlo call
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        P.plan(rows_in.cpu().numpy(), base)
    log(f"netlist_exec plan lookup ({n_bits}-bit, rows_in "
        f"{rows_in.numel() * 4} bytes to the host and a cache hit): "
        f"{(time.perf_counter() - t0) / reps * 1e3:.3f} ms a launch "
        f"(host clock)")
    del state, masks
    torch.cuda.empty_cache()
    return timed


def check_netlist_exec(torch, dev):
    from repro_torch.core import multpim

    timed = check_netlist_modes(torch, dev, N_BITS, MC_TRIALS, SEED + 5,
                                narrow=True)
    # phase 7 (b)'s shape: one single-fault trial per gate, flip only
    G = multpim.multiplier_netlist(N_BITS).n_gates
    single = check_netlist_modes(torch, dev, N_BITS, G, SEED + 7)["xor"]
    log(f"netlist_exec single-fault shape ({G} trials, xor): kernel "
        f"{single[0]:.4f} ms, bound {single[2][0]:.4f} ms")
    # a schedule whose plan takes a narrower tile: the 64-bit multiplier
    check_netlist_modes(torch, dev, NARROW_BITS, NARROW_TRIALS, SEED + 8)
    # the row times the Monte Carlo runs' mode, and names it: a row of
    # another mode is not the same measurement
    ms, plain_ms, bnd = timed["xor"]
    return {"netlist_exec": dict(row(
        "netlist_exec", "src/repro_torch/kernels/csrc/netlist_exec.cu",
        "src/repro/kernels/netlist_exec/kernel.py:76", ms, plain_ms, bnd,
        0.0), mode="xor")}


def check_crossbar_nor_shape(torch, dev, n_bits, trials, seed):
    """crossbar_nor over the n_bits multiplier's gate list at `trials`
    trials (random words in every wire) against the plain version, bit for
    bit, through the op.  Timed three ways: the op on a CUDA gate list (the
    row's ms, as earlier trees timed it: the list's copy to the host, the
    plan lookup, the launch), `launch` from the host list (execute_netlist's
    route, no copy back), and the kernel's binding alone at the op's tile;
    the plan on a line of its own and its lookup by the host clock.
    Returns (op ms, binding ms, plain ms, bound)."""
    from repro_torch.core import multpim
    from repro_torch.kernels.crossbar_nor import crossbar_nor, crossbar_nor_ref
    from repro_torch.kernels.crossbar_nor import kernel
    from repro_torch.kernels.crossbar_nor import plan as CP
    from repro_torch.kernels.crossbar_nor.ops import launch
    from repro_torch.kernels.netlist_exec.plan import launch_tile

    nl = multpim.multiplier_netlist(n_bits)
    tw = -(-trials // 32)
    plan = CP.plan(nl.gates, nl.n_wires)
    tile = launch_tile(plan.tile(), tw, torch.cuda.get_device_properties(
        dev).multi_processor_count) if dev.type == "cuda" else plan.tile()
    log(f"crossbar_nor plan ({n_bits}-bit multiplier, {nl.n_gates} gates, "
        f"{nl.n_wires} wires, {trials} trials): L={plan.L} levels of "
        f"W={plan.W} ({plan.gate_levels} with gates, ASAP depth "
        f"{plan.depth}; the rest only flush), {plan.n_slots} live slots, "
        f"{len(plan.base_wire)} base rows, {len(plan.copy_wire)} wires "
        f"copied; trial tile {tile} words, {-(-tw // tile)} CTAs over {tw} "
        f"words")
    g = torch.Generator(device=dev).manual_seed(seed)
    state = random_words(torch, tw * nl.n_wires, g, dev).view(tw, nl.n_wires)
    gates = torch.as_tensor(nl.gates, device=dev)
    got = crossbar_nor(gates, state)
    plain, plain_ms = timed_once(torch, lambda: crossbar_nor_ref(gates,
                                                                 state))
    check(torch.equal(got, plain),
          f"crossbar_nor kernel != plain version ({n_bits}-bit)")
    check(torch.equal(launch(nl.gates, state), plain),
          f"crossbar_nor from the host list != plain version ({n_bits}-bit)")
    del plain
    op_ms = time_ms(torch, lambda: crossbar_nor(gates, state), reps=10)
    host_ms = time_ms(torch, lambda: launch(nl.gates, state), reps=10)
    ms = time_ms(torch, lambda: kernel.crossbar_nor(plan, tile, state, got),
                 reps=10)
    bnd = bound_ms(2 * state.numel() * 4 + gates.numel() * 4,
                   6 * nl.n_gates * tw)
    log(f"crossbar_nor ({n_bits}-bit, {trials} trials, {tile}-word tile): "
        f"op {op_ms:.4f} ms a call (CUDA gate list); from the host list "
        f"{host_ms:.4f} ms a call; kernel {ms:.4f} ms, "
        f"{ms / max(plan.L, 1) * 1e3:.3f} us a level over {plan.L} levels "
        f"(ASAP depth {plan.depth}); plain {plain_ms:.1f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}; latency a level bounds the walk); "
        f"bit-exact")
    # the host work a launch, by the host clock: the CUDA list to the host
    # and its plan from the cache (the op), or the lookup alone (the host
    # list, as execute_netlist launches)
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        CP.plan(gates.cpu().numpy(), nl.n_wires)
    t1 = time.perf_counter()
    for _ in range(reps):
        CP.plan(nl.gates, nl.n_wires)
    t2 = time.perf_counter()
    log(f"crossbar_nor plan lookup ({n_bits}-bit, gates {gates.numel() * 4} "
        f"bytes, a cache hit): {(t1 - t0) / reps * 1e3:.3f} ms a launch "
        f"with the copy to the host, {(t2 - t1) / reps * 1e3:.3f} ms from "
        f"the host list (host clock)")
    del state, got
    torch.cuda.empty_cache()
    return op_ms, ms, plain_ms, bnd


def check_crossbar_nor(torch, dev):
    from repro_torch.core import multpim

    # phase 7's golden run: one trial per gate (the row's shape)
    G = multpim.multiplier_netlist(N_BITS).n_gates
    op_ms, ms, plain_ms, bnd = check_crossbar_nor_shape(torch, dev, N_BITS,
                                                        G, SEED + 6)
    # 56,386 wires: a trial word's whole row (225.5 KB) would all but fill
    # a CTA's shared memory; its live versions take a tenth of that
    check_crossbar_nor_shape(torch, dev, NARROW_BITS, NARROW_TRIALS,
                             SEED + 9)
    # the row times the op, as earlier trees' rows did; the binding alone
    # is beside it
    return {"crossbar_nor": dict(row(
        "crossbar_nor", "src/repro_torch/kernels/csrc/crossbar_nor.cu",
        "src/repro/kernels/crossbar_nor/kernel.py:40", op_ms, plain_ms, bnd,
        0.0), binding_ms=ms)}


# ----------------------------------------------------------------------------
# 4. the one-shot serve path
# ----------------------------------------------------------------------------

def run_main_path(torch, cfg, inputs):
    from repro_torch.core import arena

    params, tokens = inputs["params"], inputs["tokens"]
    clean, spec = arena.words_of(params)
    log(f"{cfg.name}: {spec.n_words} arena words ({spec.n_words * 4 / 1e9:.2f}"
        f" GB fp32)")

    runs = [("off", 0.0, {}), ("ecc", 1e-9, {}),
            ("ecc+tmr-parallel", 1e-9, dict(vote_every=8, vote_cache=True))]
    clean_tokens, counts = None, {}
    for spec_s, p_bit, kw in runs:
        out, counts[spec_s] = serve_and_check(
            torch, cfg, params, tokens, clean, spec_s, p_bit, kw,
            clean_tokens)
        clean_tokens = out if clean_tokens is None else clean_tokens
    main = counts["ecc+tmr-parallel"]
    log(f"one-shot main path (ecc+tmr-parallel) launches: {main}")
    return main


def serve_and_check(torch, cfg, params, tokens, clean, spec_s, p_bit, kw,
                    clean_tokens, modality=None):
    """One serve run with its launch counts and checks; the store it built
    is freed on return.  `clean_tokens` (None: only the agreement with
    `serve`'s own clean run is checked) are the tokens a protected run
    must give; `modality` the stub modality inputs.  Returns (tokens,
    launch counts)."""
    from repro_torch import kernels
    from repro_torch.launch.serve import serve
    from repro_torch.reliability import parse_scheme

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = serve(cfg, params, tokens, parse_scheme(spec_s), gen=32,
                p_bit=p_bit, seed=SEED, device=clean.device,
                modality=modality, **kw)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lat = res["latency"]
    log(f"{spec_s}: launches {counts}, {res['tok_s']:.1f} tok/s"
        + (f", ttft {lat['ttft_s'] * 1e3:.1f} ms" if lat else "")
        + f", peak device memory {peak / 1e9:.2f} GB")
    check(peak < 80e9, f"{spec_s}: peak {peak / 1e9:.2f} GB")
    out, stats = res["tokens"], res["stats"]
    # greedy ids range over the head's padded vocabulary (pad ids have
    # live logits at random init, as in the reference)
    check(tuple(out.shape) == (tokens.shape[0], 32)
          and out.dtype == torch.int32
          and int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab,
          f"{spec_s}: bad tokens {tuple(out.shape)} {out.dtype} "
          f"[{int(out.min())}, {int(out.max())}]")
    check(res["agreement"] == 1.0, f"{spec_s}: agreement "
          f"{res['agreement']} with the clean run")
    if spec_s != "off":
        check(int(stats["ecc_corrected"]) > 0, f"{spec_s}: no corrections")
        check(int(stats["ecc_uncorrectable"]) == 0,
              f"{spec_s}: uncorrectable blocks")
        check_copies_clean(torch, res["store"], 3 if "tmr" in spec_s else 1,
                           clean, spec_s)
        check(clean_tokens is None or torch.equal(out, clean_tokens),
              f"{spec_s}: tokens differ from the clean run")
    if "tmr" in spec_s:
        check(int(stats["tmr_final_disagreements"]) == 0
              and int(stats["tmr_step_disagreements"].sum()) == 0,
              f"{spec_s}: copies disagree after the scrub")
    return out, counts


# ----------------------------------------------------------------------------
# 5. the server path
# ----------------------------------------------------------------------------

#: phase 5's server runs: (scheme, weight p_bit, pool exposure a tick,
#: pool scrub cadence in ticks)
SERVER_RUNS = [("off", 0.0, None, 0), ("ecc", 1e-9, "inject_scrub", 0),
               ("hsiao-wb", 1e-9, "corrupt", 4),
               ("hsiao+tmr-parallel", 1e-9, None, 0)]


#: the server pool's exposure a tick (phases 5 and 11)
POOL_P_BIT = 1e-8


def run_server_path(torch, cfg, params, runs=SERVER_RUNS, what=""):
    """The server runs (phase 5's four unless `runs` says otherwise) and
    the join-live check; returns the launch counts summed over the runs
    (each counted from 0 around its run) and the `off` run's tokens by
    request."""
    from repro_torch import kernels
    from repro_torch.faults import TransientBitFlips
    from repro_torch.launch.batching import (ContinuousBatcher, Request,
                                             poisson_trace)
    from repro_torch.launch.serve import serve_server
    from repro_torch.obs import fetch_telemetry
    from repro_torch.reliability import parse_scheme

    dev = params["final_ln"].device
    spec = server_spec()
    pool_fault = TransientBitFlips(POOL_P_BIT)
    clean, total = None, {}
    for name, p_bit, exposure, scrub_every in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        pool = []

        def expose(b, exposure=exposure, pool=pool, g=g):
            if exposure == "inject_scrub":
                pool.append(b.pool.inject_scrub(g, pool_fault))
            else:
                pool.append(b.pool.corrupt(g, pool_fault)[None])

        kernels.reset_launch_counts()
        res = serve_server(cfg, params, parse_scheme(name), spec=spec,
                           requests=8, rate=2.0, p_bit=p_bit, seed=SEED,
                           scrub_every=scrub_every,
                           on_tick=expose if exposure else None, device=dev)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        stats, b = res["stats"], res["batcher"]
        tokens = {r.rid: r.tokens for r in res["results"]}
        exp = torch.stack(pool).sum(0).tolist() if pool else []
        lat = res["latency"]
        log(f"{what}server {name}: goodput "
            f"{res['goodput_tok_s']:.2f} tok/s, ttft p50/p99 "
            f"{lat['ttft_p50_s'] * 1e3:.1f}/"
            f"{lat['ttft_p99_s'] * 1e3:.1f} ms, tpot p50/p99 "
            f"{lat['tpot_p50_s'] * 1e3:.2f}/{lat['tpot_p99_s'] * 1e3:.2f} "
            f"ms, {b.ticks} ticks, scrub ticks {b.scrub_ticks}, counters "
            f"{ {k: int(v.sum()) for k, v in stats.items()} }, pool "
            f"exposure {exposure} {exp}, peak device memory "
            f"{peak / 1e9:.2f} GB, launches {counts}")
        bad = {rid: (t.dtype, t.shape, int(t.min()), int(t.max()))
               for rid, t in tokens.items()
               if not (t.dtype == np.int32 and t.size and 0 <= t.min()
                       and t.max() < cfg.padded_vocab)}
        check(len(tokens) == 8 and not bad,
              f"server {name}: bad results {bad}")
        del res, b
        if clean is None:
            clean = tokens
            continue
        for rid, t in clean.items():
            check(np.array_equal(tokens[rid], t),
                  f"server {name}: request {rid} tokens differ from off")
        check(int(stats["ecc_corrected"]) > 0, f"server {name}: no "
              f"corrections")
        check(int(stats["ecc_uncorrectable"]) == 0
              and int(stats["ecc_read_uncorrectable"]) == 0,
              f"server {name}: uncorrectable blocks")
        if exposure == "inject_scrub":
            check(exp[0] > 0 and exp[1] > 0 and exp[3] == 0,
                  f"server {name}: pool inject_scrub counts {exp}")
        if name == "hsiao-wb":
            check(int(stats["ecc_read_corrected"]) > 0,
                  f"server {name}: no write-back-on-read corrections")
        if "tmr" in name:
            check(int(stats["tmr_final_disagreements"]) == 0,
                  f"server {name}: vote disagreements")
    log(f"{what}server path launches ({len(runs)} runs): {total}")

    # a request joining a live hsiao-wb batch == the same request alone
    trace = poisson_trace(5, rate_rps=2.0, spec=spec, vocab=cfg.vocab,
                          seed=SEED)
    live = [Request(i, trace[i].prompt, gen)
            for i, gen in enumerate((32, 8, 8, 32))]
    live.append(Request(9, trace[4].prompt, 16, arrival_s=0.1))
    out = []
    for reqs in (live, [Request(9, trace[4].prompt, 16)]):
        torch.cuda.empty_cache()
        b = ContinuousBatcher(cfg, parse_scheme("hsiao-wb"), spec,
                              device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 100)
        prep = b.prepare(params, generator=g, fault=TransientBitFlips(1e-9))
        res = {r.rid: r for r in b.run(reqs)}
        stats = fetch_telemetry({**prep, **b.telemetry()})
        stats.pop("tokens_emitted")
        out.append((res[9], stats, b.ticks))
        del b, prep
    (a, pa, ta), (s, ps, ts) = out
    check(np.array_equal(a.tokens, s.tokens)
          and a.vote_disagreements == s.vote_disagreements
          and all(int(pa[k]) == int(ps[k]) for k in pa) and a.ttft_s > 0,
          f"{what}hsiao-wb: a request in a live batch != the same request "
          f"alone")
    log(f"{what}join-live == alone (hsiao-wb, full width): request 9's 16 "
        f"tokens and counters {dict((k, int(v)) for k, v in pa.items())} "
        f"equal; "
        f"{ta} ticks live, {ts} alone")
    return total, clean


# ----------------------------------------------------------------------------
# 7. the netlist path (paper Fig. 4)
# ----------------------------------------------------------------------------

def popcount_total(torch, words) -> int:
    """Set bits in an int32 tensor, counted in chunks of rows."""
    from repro_torch.core.bitops import as_u64, popcount32
    flat = words.reshape(-1)
    step = 1 << 26
    return sum(int(popcount32(as_u64(flat[i:i + step])).sum())
               for i in range(0, flat.numel(), step))


def run_netlist_path(torch, dev):
    """(a)-(c) of phase 7; returns the launch counts of the path's runs."""
    from repro_torch import kernels
    from repro_torch.core import analytics as A
    from repro_torch.core import multpim
    from repro_torch.faults import TransientGateFaults, wilson_interval
    from repro_torch.reliability import backend

    nl = multpim.multiplier_netlist(N_BITS)
    G = nl.n_gates
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) fault-free products of 2^20 random operand pairs
    a, b = operands(torch, MC_TRIALS, 42, dev)
    want = multpim.true_product_bits(a, b, N_BITS)
    bits, sec = timed(lambda: multpim.multiply_bits(a, b, N_BITS))
    check(bits.shape == want.shape and bits.device == want.device
          and torch.equal(bits, want),
          f"netlist (a): {int((bits != want).any(1).sum())} of {MC_TRIALS} "
          f"fault-free products wrong")
    log(f"netlist (a): {MC_TRIALS} fault-free {N_BITS}-bit products all "
        f"right in {sec:.3f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del bits

    # (b) one single-fault trial per gate position, and the golden run
    a0, b0 = operands(torch, G, 0, dev)
    want0 = multpim.true_product_bits(a0, b0, N_BITS)
    bits, sec = timed(lambda: multpim.multiply_bits(
        a0, b0, N_BITS, fault_gate=torch.arange(G, device=dev)))
    wrong = int((bits != want0).any(1).sum())
    alpha = wrong / G
    log(f"netlist (b): single faults corrupt {wrong} of {G} products "
        f"(alpha {alpha:.4f}) in {sec:.3f} s")
    check(wrong == SINGLE_FAULT_WRONG_32,
          f"netlist (b): {wrong} corrupted products, the reference counts "
          f"{SINGLE_FAULT_WRONG_32}")
    golden, sec = timed(lambda: backend.dispatch("crossbar_nor")(
        nl, multpim._pack_inputs(a0, b0, N_BITS)))
    check(torch.equal(golden, want0), "netlist (b): crossbar_nor golden run "
          "!= true products")
    log(f"netlist (b): gate-serial crossbar_nor golden run over {G} trials "
        f"right in {sec:.3f} s")
    del bits, golden, want0, a0, b0

    # (c) Monte Carlo at the campaign's rates, and TMR
    for i, p in enumerate(FIG4_PGATES + (FIG4_PGATES[-1],)):
        tmr = i == len(FIG4_PGATES)
        seed = SEED + 20 + i
        if not tmr:
            # the path's first draw from a generator seeded so is its gate
            # plane: the same draw here counts the lanes the run flips
            _, flip = TransientGateFaults(p).gate_lane_masks(
                torch.Generator(device=dev).manual_seed(seed), G, MC_TRIALS)
            flips = popcount_total(torch, flip)
            del flip
            mean = p * G * MC_TRIALS
            half = Z99 * math.sqrt(mean * (1 - p))
            check(abs(flips - mean) <= half,
                  f"netlist (c): {flips} flipped gate lanes at p {p:g}, "
                  f"binomial 99% interval {mean:.0f} +- {half:.0f}")
        gen = torch.Generator(device=dev).manual_seed(seed)
        if tmr:
            bits, sec = timed(lambda: multpim.multiply_tmr_bits(
                a, b, N_BITS, gen, p))
            model = float(A.p_mult_tmr(np.array([p]), alpha, G)[0])
        else:
            bits, sec = timed(lambda: multpim.multiply_bits(
                a, b, N_BITS, generator=gen, p_gate=p))
            model = float(A.p_mult_from_alpha(np.array([p]), alpha, G)[0])
        fail = (bits != want).any(1)
        k, k4 = int(fail.sum()), int(fail[:4096].sum())
        lo, hi = wilson_interval(k, MC_TRIALS, Z99)
        lo4, hi4 = wilson_interval(k4, 4096, Z99)
        name = f"{'tmr ' if tmr else ''}p_gate {p:g}"
        log(f"netlist (c) {name}: p_hat {k / MC_TRIALS:.5f} 99% "
            f"[{lo:.5f}, {hi:.5f}] over {MC_TRIALS}; {k4 / 4096:.4f} "
            f"[{lo4:.4f}, {hi4:.4f}] over 4096; closed form "
            f"{'p_mult_tmr (upper bound)' if tmr else 'p_mult_from_alpha'} "
            f"{model:.5f}" + ("" if tmr else f"; {flips} flipped gate lanes, "
                              f"expected {mean:.0f} +- {half:.0f}")
            + f"; {sec:.3f} s")
        if tmr:
            check(lo4 <= model, f"netlist (c) {name}: closed-form upper "
                  f"bound {model:.4f} below the 4096-trial interval "
                  f"[{lo4:.4f}, {hi4:.4f}]")
        else:
            check(lo4 <= model <= hi4, f"netlist (c) {name}: closed form "
                  f"{model:.4f} outside the 4096-trial interval "
                  f"[{lo4:.4f}, {hi4:.4f}]")
        del bits, fail
    counts = kernels.launch_counts()
    log(f"netlist path: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{counts}")
    log("netlist_exec launches by mode and shape (netlist path): " + ", ".join(
        f"{shape}: {n}" for (name, shape), n in
        sorted(kernels.launch_shapes().items()) if name == "netlist_exec"))
    del a, b, want
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------------
# 8. the campaigns (paper Fig. 4 bottom, Fig. 5, the scheme grid)
# ----------------------------------------------------------------------------

#: AlexNet's weight store (`AlexNetCaseStudy.W`, paper §VI): 62e6 32-bit
#: words, 1,937,500 32-word ECC blocks, one Fig. 5 trial each
CASE_STUDY_WORDS = 62_000_000
CASE_STUDY_BLOCKS = CASE_STUDY_WORDS // 32
#: the store simulation's rate and scrubs (`benchmarks/fig5_weights.py`)
SIM_P_BIT, SIM_SCRUBS = 2e-6, 32


def check_campaign_shapes(torch, dev):
    """Every kernel of phase 8 at the shapes the campaigns give it, held
    against its plain version on the same inputs, bit for bit (run before
    the counts are reset, so these launches are not the path's):
    netlist_exec over one Fig. 4 batch of each kind at p_gate 3e-5, its
    inputs and fault masks drawn as the campaign draws its first batch
    (1024 products: 32 trial words, a narrower launch tile than phase 3's;
    the TMR batch's three launches and faulty voting gates; 16,384 NN
    products: 512 words), against the `level` plain version; and over the
    case study's store of 62e6 words: encode_parity and the first scrub of
    `simulate_store`, the grid ECC scheme's scrub at its rate, the ECC+TMR
    scrub of three copies against their own tables, tmr_vote of the grid's
    three copies, and the first Fig. 5 interval of inject_scrub at each
    p_input."""
    from repro_torch.core import multpim, scheduler
    from repro_torch.experiments import campaign_mc as C
    from repro_torch.faults import (TransientBitFlips, derive_seed,
                                    inject_bit_flips)
    from repro_torch.kernels import diag_parity as D
    from repro_torch.kernels.inject_scrub import (inject_scrub,
                                                  inject_scrub_ref)
    from repro_torch.kernels.netlist_exec import plan as P
    from repro_torch.kernels.tmr_vote import vote, vote_ref

    mode = C.FULL
    p_gate = mode.fig4_pgates[-1]
    sch = scheduler.schedule(multpim.multiplier_netlist(mode.n_bits))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def fig4_batch(impl, seed, n, tmr):
        """The first batch of the campaign seeded `seed` (run_campaign's
        batch generator, the trial's operand draws)."""
        g = torch.Generator(device=dev).manual_seed(derive_seed(seed, 0))
        a, b = (torch.randint(0, 2**mode.n_bits, (n,), dtype=torch.int64,
                              generator=g, device=dev) for _ in range(2))
        if tmr:
            bits = multpim.multiply_tmr_bits(a, b, mode.n_bits, g, p_gate,
                                             impl=impl)
        else:
            bits = multpim.multiply_bits(a, b, mode.n_bits, generator=g,
                                         p_gate=p_gate, impl=impl)
        return bits, (bits != multpim.true_product_bits(a, b, mode.n_bits)
                      ).any(-1)

    for kind, seed, n, tmr in (
            ("mult", derive_seed(C.SEED, 1), mode.batch, False),
            ("tmr", derive_seed(C.SEED, 200), mode.batch, True),
            ("nn", derive_seed(C.SEED, 101), mode.batch * mode.m_scaled,
             False)):
        got, wrong = fig4_batch("kernel", seed, n, tmr)
        plain, _ = fig4_batch("level", seed, n, tmr)
        check(torch.equal(got, plain), f"netlist_exec kernel != plain "
              f"version on the {kind} campaign's batch ({n} trials)")
        tw = -(-n // 32)
        tile = P.launch_tile(P.plan(sch.rows_in, sch.base).tile(1), tw, sms)
        log(f"campaign shapes: netlist_exec, the {kind} campaign's first "
            f"batch ({n} trials, {tw} words, {tile}-word tile, p_gate "
            f"{p_gate:g}): {int(wrong.sum())} wrong products; bit-exact")

    n = CASE_STUDY_WORDS

    def hold_scrub(what, words, parity):
        w_p, par_p = words.clone(), parity.clone()
        _, _, counts = D.scrub(words, parity)
        _, _, counts_p = D.scrub_ref(w_p, par_p)
        check(torch.equal(words, w_p) and torch.equal(parity, par_p)
              and torch.equal(counts, counts_p),
              f"scrub kernel != plain version ({what})")
        log(f"campaign shapes: scrub, {what}: counts {counts.tolist()}; "
            f"bit-exact")

    # simulate_store's weights and first batch of flips (its generator)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(n, generator=g, device=dev)
    words = w.view(torch.int32)
    par = D.encode_parity(words)
    check(torch.equal(par, D.encode_parity_ref(words)),
          "encode_parity kernel != plain version (the store, 62e6 words)")
    log(f"campaign shapes: encode_parity, the store ({n} fp32 words): "
        f"bit-exact")
    inject_bit_flips({"w": w}, g, SIM_P_BIT)
    hold_scrub(f"the store's first scrub at p_bit {SIM_P_BIT:g}", words, par)
    # the grid's schemes at its rate over random words
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    words = random_words(torch, n, g, dev)
    par = D.encode_parity(words)
    model = TransientBitFlips(C.GRID_P_INPUT)
    w1 = words.clone()
    model.corrupt({"w": w1}, g)
    hold_scrub(f"the grid's ECC at p_input {C.GRID_P_INPUT:g}", w1,
               par.clone())
    w3 = words.repeat(3).view(3, n)
    model.corrupt({"c0": w3[0], "c1": w3[1], "c2": w3[2]}, g)
    check(torch.equal(vote(w3[0], w3[1], w3[2]), vote_ref(w3[0], w3[1],
                                                           w3[2])),
          "tmr_vote kernel != plain version (the grid's 3 x 62e6 words)")
    log(f"campaign shapes: tmr_vote, the grid's 3 x {n} int32 words at "
        f"p_input {C.GRID_P_INPUT:g}: bit-exact")
    hold_scrub("ECC+TMR's three copies against their own tables",
               w3.view(-1), par.repeat(3, 1))
    del w, w1, w3, words, par
    # inject_scrub: the Fig. 5 sweep's first interval at each point
    for i, pt in enumerate(C.FIG5_POINTS):
        seed = derive_seed(derive_seed(derive_seed(C.SEED, 300), i), 0)
        g = torch.Generator(device=dev).manual_seed(seed)
        buf = torch.randint(-2**31, 2**31, (n,), dtype=torch.int64,
                            generator=g, device=dev).to(torch.int32)
        par = D.encode_parity(buf)
        mask = TransientBitFlips(pt["p_input"]).word_mask(g, buf)
        buf_p, par_p = buf.clone(), par.clone()
        _, _, counts = inject_scrub(buf, par, mask)
        _, _, counts_p = inject_scrub_ref(buf_p, par_p, mask)
        check(torch.equal(buf, buf_p) and torch.equal(par, par_p)
              and torch.equal(counts, counts_p),
              f"inject_scrub kernel != plain version (Fig. 5 at p_input "
              f"{pt['p_input']:g})")
        log(f"campaign shapes: inject_scrub, the Fig. 5 sweep's first "
            f"interval at p_input {pt['p_input']:g} ({n // 32} blocks): "
            f"counts {counts.tolist()}; bit-exact")
        del buf, par, mask, buf_p, par_p
    torch.cuda.empty_cache()


def run_campaign_path(torch, dev):
    """(a)-(e) of phase 8; returns the launch counts of the path's runs.
    The checks are the experiments' own (AssertionError) and this
    phase's."""
    from repro_torch import kernels
    from repro_torch.core import analytics as A
    from repro_torch.core import multpim
    from repro_torch.experiments import campaign_mc as C
    from repro_torch.experiments import fig4_nn, fig5_weights

    cs = A.AlexNetCaseStudy()
    check(cs.W == CASE_STUDY_WORDS, f"the case study's W is {cs.W:g}")
    # phase 7 (b) checked that its single-fault count is exactly this
    alpha = SINGLE_FAULT_WRONG_32 / multpim.multiplier_netlist(N_BITS).n_gates
    store = C.store_config(CASE_STUDY_BLOCKS)
    check_campaign_shapes(torch, dev)
    kernels.reset_launch_counts()
    t_path = time.perf_counter()

    def show(part, rows):
        for name, _, derived in rows:
            log(f"campaigns ({part}) {name}: {derived}")

    # (a) Fig. 4 at the reference's full-mode budget
    rows, res = C.fig4(alpha, C.FULL, dev)
    show("a", rows)
    check(all(2048 <= r.n_trials <= 4096 for r in res),
          f"campaigns (a): trials {[r.n_trials for r in res]}")

    # (b) Fig. 5 over the whole store, one batch a point
    rows, res = C.fig5(store, dev)
    show("b", rows)
    for pt, r in zip(C.FIG5_POINTS, res):
        check(r.n_trials == CASE_STUDY_BLOCKS,
              f"campaigns (b): {r.n_trials} trials, not the store's blocks")
        exp = A.expected_scrub_rates(pt["p_input"], CASE_STUDY_BLOCKS)
        log(f"campaigns (b) {r.name}: corrected {r.extras['corrected']:.0f} "
            f"(T x expected {pt['T'] * exp['corrected_per_scrub']:.0f}), "
            f"uncorrectable {r.extras['uncorrectable']:.0f} (T x expected "
            f"new {pt['T'] * exp['uncorrectable_per_scrub']:.0f}; a failed "
            f"block stays uncorrectable at every later scrub)")

    # (c) the scheme grid over the same blocks, on the kernels
    rows, res = C.scheme_grid(store, dev)
    show("c", rows)
    check(all(r.n_trials == CASE_STUDY_BLOCKS for r in res),
          "campaigns (c): a scheme ran fewer trials than the store's blocks")

    # (d) the closed-form curves at phase 7's alpha
    show("d", fig4_nn.run(dev, alpha=alpha) + fig5_weights.run(dev))

    # (e) the store simulation at the case study's size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ecc = fig5_weights.simulate_store(SIM_P_BIT, SIM_SCRUBS, CASE_STUDY_WORDS,
                                      dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    plain = fig5_weights.simulate_store(SIM_P_BIT, SIM_SCRUBS,
                                        CASE_STUDY_WORDS, dev,
                                        protected=False)
    T = np.array([SIM_SCRUBS])
    refined = cs.W * float(A.weight_corruption_ecc_refined(SIM_P_BIT, T,
                                                           m=32)[0])
    bound = cs.W * float(A.weight_corruption_ecc(SIM_P_BIT, T, m=32)[0])
    log(f"campaigns (e) simulate_store: {CASE_STUDY_WORDS} fp32 weights, "
        f"p_bit {SIM_P_BIT:g}, {SIM_SCRUBS} scrubs: {ecc} corrupted under "
        f"ECC, {plain} unprotected (the same flips, no scrub); W x "
        f"weight_corruption_ecc_refined(m=32) {refined:.1f}, W x "
        f"weight_corruption_ecc(m=32) {bound:.1f}; {sec:.3f} s "
        f"({SIM_SCRUBS / sec:.1f} scrubs/s), peak device memory "
        f"{peak / 1e9:.2f} GB")
    check(ecc < plain, f"campaigns (e): {ecc} corrupted under ECC, not "
          f"fewer than the unprotected {plain}")
    check(ecc <= bound, f"campaigns (e): {ecc} corrupted under ECC, above "
          f"the conservative bound {bound:.1f}")

    counts = kernels.launch_counts()
    log(f"campaign path: {time.perf_counter() - t_path:.1f} s, launches "
        f"{counts}")
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------------
# 9. the rest of the serve entry point
# ----------------------------------------------------------------------------

#: phase 9's fault rates: the weights' (one-shot and server), the server
#: pool's retention drift per unit of time (one tick exposes `chunk` units)
P9_WEIGHTS = 1e-9
P9_POOL = 1e-8
#: (d): served ticks with no pool exposure before the drift storm
P9_QUIET_TICKS = 3


def binom99(n: int, p: float, k: int = 1):
    """The binomial 99% interval of a count of n trials at rate p; for one
    of k counts checked together, the interval at 1 - 0.01 / k, so that
    all k hold at 99% (Bonferroni)."""
    from scipy.stats import binom
    lo, hi = binom.interval(1 - 0.01 / k, n, p)
    return int(lo), int(hi)


def check_scrub_counts(loop, bits, what, p_bit=None):
    """Every scrub's corrected count inside its binomial interval (99% over
    the run's scrubs) and the run's total inside its 99% interval; no
    uncorrectable word.  `bits` counts the stored bits of every held data
    copy, each exposed at `p_bit` (default P10_P_BIT) a scrub interval."""
    p_bit = P10_P_BIT if p_bit is None else p_bit
    k = len(loop.scrub_reports)
    lo, hi = binom99(bits, p_bit, k)
    counts = [int(r.corrected) for _, r in loop.scrub_reports]
    tlo, thi = binom99(k * bits, p_bit)
    log(f"{what} corrected {counts} at steps "
        f"{[s for s, _ in loop.scrub_reports]} (each in [{lo}, {hi}], 99% "
        f"over {k} scrubs of {bits} bits at {p_bit:g}; total "
        f"{sum(counts)} in [{tlo}, {thi}])")
    check(all(lo <= c <= hi for c in counts) and tlo <= sum(counts) <= thi,
          f"{what} corrected {counts} outside [{lo}, {hi}] or total "
          f"outside [{tlo}, {thi}]")
    check(all(int(r.uncorrectable) == 0 for _, r in loop.scrub_reports),
          f"{what} uncorrectable words")


def leaf_bits(params) -> int:
    """Stored bits over the leaves of a parameter tree."""
    from repro_torch.core import tree
    return sum(x.numel() * x.element_size() * 8 for x in tree.leaves(params))


def run_serve_rest_path(torch, cfg, server_clean, dev):
    """(a)-(e) of phase 9; returns the launch counts of the path's runs,
    each counted from 0 around its run."""
    from repro_torch import kernels
    from repro_torch.launch.serve import make_inputs

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    inputs = make_inputs(cfg, batch=4, prompt_len=256, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"phase 9: {cfg.name} random init again in "
        f"{time.perf_counter() - t0:.1f}s (the same seed as phase 4)")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    kernels.reset_launch_counts()
    add(check_fault_runs(torch, cfg, inputs))
    add(check_chunked_runs(torch, cfg, inputs))
    check_cost_model(torch, cfg, dev)
    add(check_adaptive_server(torch, cfg, inputs["params"], server_clean))
    del inputs
    torch.cuda.empty_cache()
    check_crossbar_on_card(torch, dev)
    log(f"phase 9: {time.perf_counter() - t_path:.1f} s, launches {total}")
    return total


def check_fault_runs(torch, cfg, inputs):
    """(a) --fault stuckat / drift under ecc and ecc+tmr-parallel, one-shot,
    with --mmpu-cost --mmpu-events: tokens == the clean run's, no
    uncorrectable block, the corrections inside the binomial 99% interval
    of the errors the faults make, every scrubbed copy == the clean arena,
    the event file's lines == n_events == the mmpu_events gauge."""
    from repro_torch import kernels
    from repro_torch.configs.mmpu_paper import get_device
    from repro_torch.core import arena
    from repro_torch.launch.serve import serve
    from repro_torch.reliability import parse_scheme

    params, tokens = inputs["params"], inputs["tokens"]
    clean, _ = arena.words_of(params)
    bits = leaf_bits(params)
    log(f"phase 9 (a): {bits} stored weight bits a copy")
    events = ROOT / "build" / "phase9"
    events.mkdir(parents=True, exist_ok=True)
    total = {}
    for fault in ("stuckat", "drift"):
        for spec_s in ("ecc", "ecc+tmr-parallel"):
            copies = 3 if "tmr" in spec_s else 1
            path = events / f"{fault}_{spec_s}.jsonl"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            res = serve(cfg, params, tokens, parse_scheme(spec_s), gen=32,
                        p_bit=P9_WEIGHTS, fault=fault, seed=SEED,
                        cost_spec=get_device("paper"),
                        mmpu_events=str(path), device=clean.device)
            counts = kernels.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            peak = torch.cuda.max_memory_allocated()
            stats = res["stats"]
            # stuck-at: a bit is stuck at 0 w.p. p/2 and at 1 w.p. p/2, so
            # it is in error w.p. p/2 whatever it stores: errors ~
            # Binomial(bits, p/2) a copy.  drift: Binomial(bits, p).
            rate = P9_WEIGHTS / 2 if fault == "stuckat" else P9_WEIGHTS
            lo, hi = binom99(copies * bits, rate)
            corrected = int(stats["ecc_corrected"])
            log(f"(a) {fault} {spec_s}: prepare {res['prepare_s']:.2f} s, "
                f"{res['tok_s']:.1f} tok/s, corrected {corrected} (99% "
                f"interval [{lo}, {hi}] of {copies} x {bits} bits at "
                f"{rate:g}), parity_fixed {int(stats['ecc_parity_fixed'])}, "
                f"uncorrectable {int(stats['ecc_uncorrectable'])}, peak "
                f"device memory {peak / 1e9:.2f} GB, launches {counts}")
            check(res["agreement"] == 1.0, f"(a) {fault} {spec_s}: "
                  f"agreement {res['agreement']} with the clean run")
            check(int(stats["ecc_uncorrectable"]) == 0,
                  f"(a) {fault} {spec_s}: uncorrectable blocks")
            check(lo <= corrected <= hi, f"(a) {fault} {spec_s}: corrected "
                  f"{corrected} outside [{lo}, {hi}]")
            check_copies_clean(torch, res["store"], copies, clean,
                               f"(a) {fault} {spec_s}")
            _, cost = res["mmpu"]
            with open(path) as f:
                lines = sum(1 for _ in f)
            check(lines == cost.n_events == int(stats["mmpu_events"]),
                  f"(a) {fault} {spec_s}: {lines} event lines, n_events "
                  f"{cost.n_events}, gauge {int(stats['mmpu_events'])}")
            if "tmr" in spec_s:
                check(int(stats["tmr_final_disagreements"]) == 0,
                      f"(a) {fault} {spec_s}: vote disagreements")
            del res
    return total


def check_copies_clean(torch, store, copies, clean, what):
    """Every data copy of a scrubbed store equals the clean arena (the
    views are local, so the store is freed when the caller drops it)."""
    from repro_torch.core import arena
    words, _ = arena.words_of(store, copies=3 if copies == 3 else 0)
    for i, w in enumerate(words if copies == 3 else [words]):
        check(torch.equal(w, clean), f"{what}: scrubbed copy {i} != clean")


def check_chunked_runs(torch, cfg, inputs):
    """(b) --chunk 8 under off, ecc, ecc+tmr-parallel --vote-every 8 and
    tmr-serial at p_bit 1e-9: the chunked tokens and vote counters == the
    same store's unchunked run; TTFT and TPOT p50/p95 printed."""
    from repro_torch import kernels
    from repro_torch.launch.engine import fetch_telemetry
    from repro_torch.launch.serve import serve
    from repro_torch.reliability import parse_scheme

    params, tokens = inputs["params"], inputs["tokens"]
    total = {}
    for spec_s, kw in (("off", {}), ("ecc", {}),
                       ("ecc+tmr-parallel", dict(vote_every=8)),
                       ("tmr-serial", {})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = serve(cfg, params, tokens, parse_scheme(spec_s), gen=32,
                    p_bit=P9_WEIGHTS, seed=SEED, chunk=8,
                    device=tokens.device, **kw)
        counts = kernels.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        eng, store = res["engine"], res["store"]
        with torch.no_grad():
            utok, utel = eng.generate(store, {"tokens": tokens})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ustats = fetch_telemetry(utel)
        stats, lat = res["stats"], res["latency"]
        log(f"(b) chunk 8 {spec_s} {kw}: ttft {lat['ttft_s'] * 1e3:.1f} ms, "
            f"tpot p50/p95 {lat['tpot_p50'] * 1e3:.2f}/"
            f"{lat['tpot_p95'] * 1e3:.2f} ms, {res['tok_s']:.1f} tok/s, "
            f"agreement {res['agreement']:.3f}, counters "
            f"{ {k: int(v.sum()) for k, v in stats.items()} }, peak device "
            f"memory {peak / 1e9:.2f} GB, launches {counts}")
        check(torch.equal(res["tokens"], utok),
              f"(b) {spec_s}: chunked tokens != unchunked")
        for k, v in ustats.items():
            check(k in stats and np.array_equal(stats[k], v),
                  f"(b) {spec_s}: {k} chunked {stats.get(k)} != "
                  f"unchunked {v}")
        del res, eng, store
    return total


def check_cost_model(torch, cfg, dev):
    """(c) every standard_grid() scheme's projection at phi3-mini's
    StepProfile (batch 4, gen 32), its event file, the reference
    benchmark's ordering and agreement with overhead(), and the §V
    table."""
    from repro_torch import costmodel as cm
    from repro_torch.configs.mmpu_paper import get_device
    from repro_torch.experiments import tmr_tradeoff
    from repro_torch.launch.engine import GenerationEngine
    from repro_torch.reliability import standard_grid

    spec = get_device("paper")
    t0 = time.perf_counter()
    profile = cm.StepProfile.from_model_config(cfg, batch=4)
    log(f"(c) {cfg.name} StepProfile {profile}")
    out = ROOT / "build" / "phase9"
    cyc, occ = {}, {}
    for scheme in standard_grid(include_hsiao=True):
        eng = GenerationEngine(cfg, scheme, gen=32, device=dev,
                               cost_spec=spec)
        stream, cost = eng.mmpu_projection(4)
        path = out / f"mmpu_{scheme.name}.jsonl"
        n = cm.dump_jsonl(stream, str(path))
        with open(path) as f:
            check(sum(1 for _ in f) == n == cost.n_events,
                  f"(c) {scheme.name}: event file lines != n_events")
        o = scheme.overhead()
        cyc[scheme.name] = cost.cycles_per_token
        occ[scheme.name] = o.latency_x * o.area_x / o.throughput_x
    costs = cm.evaluate_grid(standard_grid(include_hsiao=True), profile,
                             spec, device=dev)
    off = cyc["unprotected"]
    for name, c in costs.items():
        check(abs(c.cycles_per_token - cyc[name]) <= 1e-9 * cyc[name],
              f"(c) {name}: grid fold != the engine's projection")
        log(f"(c) {name}: {c.describe()}; cycles/token x{cyc[name] / off:.4f}"
            f" of off, overhead() occupancy x{occ[name]:.2f}")
    eccs = [cyc["ecc"], cyc["hsiao"]]
    tmrs = [v for k, v in cyc.items() if k.startswith("tmr-")]
    joint = [v for k, v in cyc.items() if "+" in k]
    check(cyc["unprotected"] < min(eccs) <= max(eccs) < min(tmrs)
          and max(tmrs) < min(joint), f"(c) cost ordering violated: {cyc}")
    order = sorted(cyc, key=cyc.get)
    check(order == sorted(occ, key=lambda k: (occ[k], cyc[k])),
          f"(c) event ordering {order} != overhead() ordering")
    log("(c) ordering: " + " < ".join(order))
    for name, us, derived in tmr_tradeoff.run(dev):
        print(f"{name},{us:.3f},{derived}", flush=True)
    log(f"(c) cost model and table in {time.perf_counter() - t0:.1f} s")


def check_adaptive_server(torch, cfg, params, server_clean):
    """(d) the server under hsiao-wb --adaptive-scrub (phase 5's 8
    requests, submitted at once so that every run ticks alike): the pool
    quiet for the first `P9_QUIET_TICKS` served ticks, then drifting every
    tick at RetentionDrift(1e-8) over dt = chunk.  Tokens == phase 5's off
    run, no uncorrectable word, every interval in [min, max], the
    pool-size scrub launches == the controller's recorded schedule, the
    interval doubled after `patience` quiet scrubs and halved at a storm
    scrub.  Then the schedule replayed through `forced_scrub_ticks` under
    the same exposure: the same scrub ticks, tokens and counters, bit for
    bit."""
    from repro_torch import kernels
    from repro_torch.faults import RetentionDrift
    from repro_torch.launch.serve import serve_server
    from repro_torch.reliability import parse_scheme

    dev = params["final_ln"].device
    spec = server_spec()
    drift = RetentionDrift(P9_POOL)

    def run(what, **kw):
        """One server run under the quiet-then-storm exposure, its
        results taken off the batcher so that its store is freed."""
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        flips = []

        def expose(b):
            storm = len(flips) >= P9_QUIET_TICKS
            flips.append(b.pool.corrupt(g, drift, dt=spec.chunk)[None]
                         if storm else None)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = serve_server(cfg, params, parse_scheme("hsiao-wb"), spec=spec,
                           requests=8, rate=2.0, p_bit=P9_WEIGHTS, seed=SEED,
                           on_tick=expose, realtime=False, device=dev, **kw)
        counts = kernels.launch_counts()
        b, stats = res["batcher"], res["stats"]
        out = {"counts": counts, "stats": stats, "ticks": b.ticks,
               "scrub_ticks": list(b.scrub_ticks), "adaptive": b.adaptive,
               "tokens": {r.rid: r.tokens for r in res["results"]},
               "pool_scrubs": kernels.launch_shapes().get(
                   ("scrub_hsiao", f"words {b.pool.words.numel()}"), 0)}
        lat = res["latency"]
        storm = [f for f in flips if f is not None]
        log(f"(d) {what}: goodput {res['goodput_tok_s']:.2f} tok/s "
            f"(submitted at once), ttft p50/p99 "
            f"{lat['ttft_p50_s'] * 1e3:.1f}/{lat['ttft_p99_s'] * 1e3:.1f} "
            f"ms, tpot p50/p99 {lat['tpot_p50_s'] * 1e3:.2f}/"
            f"{lat['tpot_p99_s'] * 1e3:.2f} ms, {b.ticks} ticks, scrub "
            f"ticks {b.scrub_ticks}, pool flips "
            f"{int(torch.cat(storm).sum()) if storm else 0} over "
            f"{len(storm)} storm ticks after {len(flips) - len(storm)} "
            f"quiet, counters "
            f"{ {k: int(v.sum()) for k, v in stats.items()} }, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
            f"launches {counts}")
        del res, b
        return out

    ad = run("adaptive hsiao-wb server", adaptive_scrub=True)
    ctl = ad["adaptive"]
    c = ctl.cfg
    schedule = [t for t, _, _ in ctl.history]
    events = [e for _, e, _ in ctl.history]
    intervals = [i for _, _, i in ctl.history]
    log(f"(d) controller {c}: scrubbed at ticks {schedule}, events "
        f"{events}, intervals {intervals}; {ad['pool_scrubs']} pool-size "
        f"scrub_hsiao launches")
    for rid, t in server_clean.items():
        check(rid in ad["tokens"] and np.array_equal(ad["tokens"][rid], t),
              f"(d) request {rid} tokens differ from the off run")
    check(sorted(ad["tokens"]) == sorted(server_clean),
          f"(d) requests {sorted(ad['tokens'])}")
    stats = ad["stats"]
    check(int(stats["ecc_uncorrectable"]) == 0
          and int(stats["ecc_read_uncorrectable"]) == 0,
          "(d) uncorrectable words")
    check(int(stats["ecc_corrected"]) > 0, "(d) no pool corrections")
    check(schedule and schedule == ad["scrub_ticks"]
          and ad["pool_scrubs"] == len(schedule),
          f"(d) {ad['pool_scrubs']} pool scrub launches, schedule "
          f"{schedule}, scrub ticks {ad['scrub_ticks']}")
    check(all(c.min_interval <= i <= c.max_interval for i in intervals),
          f"(d) intervals {intervals}")
    prev = [c.interval0] + intervals[:-1]
    doubled = [k for k in range(len(schedule))
               if intervals[k] == 2 * prev[k] and k + 1 >= c.patience
               and max(events[k + 1 - c.patience:k + 1]) < c.low_events]
    halved = [k for k in range(len(schedule))
              if intervals[k] == max(c.min_interval, prev[k] // 2) < prev[k]
              and events[k] > c.high_events]
    check(doubled and halved and doubled[0] < halved[0],
          f"(d) the interval did not double after {c.patience} quiet "
          f"scrubs and then halve in the storm: {ctl.history}")
    log(f"(d) the law: doubled at ticks {[schedule[k] for k in doubled]}, "
        f"halved at ticks {[schedule[k] for k in halved]}")

    rp = run("replay of the schedule", forced_scrub_ticks=schedule)
    check(rp["scrub_ticks"] == schedule
          and rp["pool_scrubs"] == len(schedule),
          f"(d) replay scrubbed at {rp['scrub_ticks']} "
          f"({rp['pool_scrubs']} pool launches), schedule {schedule}")
    check(sorted(rp["tokens"]) == sorted(ad["tokens"])
          and all(np.array_equal(rp["tokens"][r], t)
                  for r, t in ad["tokens"].items()),
          "(d) replay tokens != the adaptive run's")
    check(sorted(rp["stats"]) == sorted(stats)
          and all(np.array_equal(rp["stats"][k], v)
                  for k, v in stats.items()),
          f"(d) replay counters {rp['stats']} != {stats}")
    total = dict(ad["counts"])
    for k, v in rp["counts"].items():
        total[k] = total.get(k, 0) + v
    return total


def check_crossbar_on_card(torch, dev):
    """(e) a 1024 x 1024 crossbar: row, column and partitioned gates,
    writes and drift at zero error give the CPU's states and cycle
    counts; under stuck-at defects the pinned cells hold."""
    from repro_torch.core.crossbar import Crossbar, ErrorModel
    from repro_torch.faults import StuckAtFaults

    n = 1024
    a = np.random.default_rng(SEED + 11).random((n, n)) < 0.5
    xs = [Crossbar.from_array(torch.from_numpy(a), device=d)
          for d in ("cpu", dev)]
    rng = np.random.default_rng(SEED + 12)
    gates = (("nor", 2), ("min3", 3), ("xor", 2), ("and", 2), ("maj3", 3),
             ("not", 1), ("or", 2), ("nand", 2))
    t0 = time.perf_counter()
    for step in range(96):
        gate, k = gates[step % len(gates)]
        kind = step % 4
        if kind == 2:                    # offsets within a 64-column part
            ins = [int(c) for c in rng.choice(64, k, replace=False)]
            out = int(rng.integers(0, 64))
        else:
            ins = [int(c) for c in rng.choice(n, k, replace=False)]
            out = int(rng.integers(0, n))
        vals = torch.from_numpy(rng.random(n) < 0.5)
        for i, x in enumerate(xs):
            if kind == 0:
                xs[i] = x.row_gate(gate, ins, out)
            elif kind == 1:
                xs[i] = x.col_gate(gate, ins, out)
            elif kind == 2:
                xs[i] = x.partitioned_row_gate(gate, 64, ins, out)
            else:
                xs[i] = x.write_col(out, vals).drift(
                    torch.Generator(device=x.state.device).manual_seed(step))
    cpu, card = xs
    torch.cuda.synchronize()
    check(torch.equal(card.state.cpu(), cpu.state)
          and (card.counter.cycles, card.counter.gate_evals)
          == (cpu.counter.cycles, cpu.counter.gate_evals),
          "(e) crossbar on the card != the CPU")
    log(f"(e) crossbar {n} x {n}: 96 ops on the card == the CPU "
        f"(cycles {card.counter.cycles}, gate evaluations "
        f"{card.counter.gate_evals}) in {time.perf_counter() - t0:.1f} s")

    stuck = StuckAtFaults(1e-4, 1e-4)
    x = Crossbar.from_array(torch.from_numpy(a),
                            ErrorModel(input=stuck, retention=stuck),
                            device=dev)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa
    d1 = x.drift(seeded(1))
    d2 = d1.drift(seeded(1))
    moved = int((d1.state != x.state).sum())
    lo, hi = binom99(n * n, 1e-4)
    check(torch.equal(d1.state, d2.state), "(e) stuck cells moved when the "
          "same defect map was applied again")
    check(lo <= moved <= hi, f"(e) {moved} cells pinned away from their "
          f"value, outside [{lo}, {hi}]")
    y1 = d1.partitioned_row_gate("nor", 64, [0, 1], 2, seeded(2))
    y2 = y1.partitioned_row_gate("nor", 64, [0, 1], 2, seeded(2))
    v = y1.state.view(n, 16, 64)
    check(torch.equal(v[:, :, 2], ~(v[:, :, 0] | v[:, :, 1])),
          "(e) the gate did not read its pinned inputs")
    check(torch.equal(y1.state, y2.state), "(e) pinned inputs moved")
    log(f"(e) StuckAtFaults(1e-4, 1e-4): drift pinned {moved} cells "
        f"(99% interval [{lo}, {hi}]), held under the same map; a "
        f"partitioned NOR read its pinned inputs "
        f"({int((y1.state != d1.state).sum())} cells changed)")


# ----------------------------------------------------------------------------
# 6. small-input reference: kernels vs plain versions end to end
# ----------------------------------------------------------------------------

# ----------------------------------------------------------------------------
# 10. training
# ----------------------------------------------------------------------------

#: phase 10's soft-error rate per scrub interval (every held copy)
P10_P_BIT = 1e-9
#: depths of the runs: (a) ecc 16 of 32 layers, (b) ecc+tmr-parallel 16
#: (three copies of 32 layers with their grads and moments would not fit
#: 80 GB), (c) hsiao 1 (its checkpoints hold params, m, v and err).  (a)
#: ran the full 32 layers and (c) 2 until the script's 600 s took phase
#: 14 (PERF.md)
P10_DEPTH = {"ecc": 16, "ecc+tmr-parallel": 16, "hsiao": 1}


def p10_words(depth: int) -> int:
    """Words of phi3-mini's fp32 parameter arena at `depth` layers (one
    copy), from the layout alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import layout
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=depth)
    return layout(T.model_specs(cfg), cfg.param_dtype).n_words


def check_train_shapes(torch, dev):
    """The kernels of phase 10 at the shapes (b) and (c) give them, held
    against their plain versions on random words, bit for bit (run before
    the counts are reset, so these launches are not the path's; (a)'s
    encode is held after its run, on its own 32-layer params).  Over (b)'s
    16-layer copy: encode_parity; then flips planted in three copies and
    in their own tables, tmr_vote over the three copies, and the scrub of
    the three copies against the per-copy tables (6.03e9 words: word
    indices past 2**32).  The plain scrub runs on a gathered copy of the
    planted blocks (the code is block-local), and every other block must
    come out as it went in: the clean copy is drawn again from its seed,
    chunk by chunk, to compare.  Over (c)'s 2-layer arena: encode_hsiao
    and scrub_hsiao with planted flips."""
    from repro_torch.kernels import diag_parity as D
    from repro_torch.kernels import hsiao_secded as H
    from repro_torch.kernels.tmr_vote import vote, vote_ref

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n = p10_words(P10_DEPTH["ecc+tmr-parallel"])
    nb = n // 32
    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def arena_gen():
        return torch.Generator(device=dev).manual_seed(SEED + 11)

    def rint(hi, k):
        return torch.randint(0, hi, (k,), device=dev, generator=g)

    w3 = torch.empty((3, n), dtype=torch.int32, device=dev)
    for i, j, chunk in random_word_chunks(torch, n, arena_gen(), dev):
        w3[:, i:j] = chunk
    par = D.encode_parity(w3[0])
    plain, plain_ms = timed_once(torch, lambda: D.encode_parity_ref(w3[0]))
    check(torch.equal(par, plain),
          f"encode_parity kernel != plain version ((b)'s copy, {n} words)")
    log(f"training shapes: encode_parity over (b)'s {n}-word copy: "
        f"bit-exact; plain {plain_ms:.1f} ms")
    del plain
    # 3000 single data-bit flips and 300 doubles (two words of a block)
    # over the three copies, and 100 single-bit errors in their own
    # tables, each in its own block of the stack
    par3 = par.repeat(3, 1)
    blk = distinct_ints(torch, 3 * nb, 3400, g)
    data, prow = blk[:3300], blk[3300:]
    flat, w3v = w3.view(-1), w3.view(-1, 32)
    clean_rows = w3v[blk].clone()
    i1 = rint(32, 3300)
    flip_bits(torch, flat, data * 32 + i1, rint(32, 3300))
    i2 = (i1[3000:] + 1 + rint(31, 300)) % 32
    flip_bits(torch, flat, data[3000:] * 32 + i2, rint(32, 300))
    flip_bits(torch, par3.view(-1), prow * 3 + rint(3, 100), rint(32, 100))
    past = int((blk >= (1 << 32) // 32).sum())

    voted = vote(w3[0], w3[1], w3[2])
    # the plain voter a 2**28-word slice at a time (its temporaries of the
    # whole copy would not fit beside the three): elementwise, so exact
    plain = torch.empty_like(voted)

    def vote_plain():
        for i in range(0, n, 1 << 28):
            j = min(n, i + (1 << 28))
            plain[i:j] = vote_ref(w3[0, i:j], w3[1, i:j], w3[2, i:j])

    _, plain_ms = timed_once(torch, vote_plain)
    check(torch.equal(voted, plain),
          f"tmr_vote kernel != plain version ((b)'s 3 x {n} words)")
    log(f"training shapes: tmr_vote over (b)'s 3 x {n} words, 3300 blocks "
        f"flipped: bit-exact; plain {plain_ms:.1f} ms (in 2**28-word "
        f"slices)")
    del voted, plain

    small = w3v[blk].reshape(-1).clone()
    small_par = par3[blk].clone()
    _, _, counts = D.scrub(flat, par3)
    _, _, counts_p = D.scrub_ref(small, small_par)
    check(torch.equal(w3v[blk].reshape(-1), small)
          and torch.equal(par3[blk], small_par)
          and torch.equal(counts, counts_p),
          f"scrub kernel != plain version ((b)'s 3 x {n} words, per-copy "
          f"tables)")
    check(counts.tolist() == [3000, 100, 300],
          f"(b)'s per-copy scrub counts {counts.tolist()} != planted "
          f"[3000, 100, 300]")
    check(all(torch.equal(t, par) for t in par3.view(3, nb, 3)),
          "(b)'s per-copy tables not healed")
    del small, small_par
    w3v[blk] = clean_rows
    same = True
    for i, j, chunk in random_word_chunks(torch, n, arena_gen(), dev):
        same &= all(torch.equal(c[i:j], chunk) for c in w3)
    check(same, "the per-copy scrub changed a block outside the planted ones")
    log(f"training shapes: scrub of (b)'s 3 x {n} words ({3 * n} word "
        f"indices) against per-copy tables: counts {counts.tolist()} "
        f"({past} planted blocks past word 2**32) bit-exact, tables healed, "
        f"no other block changed")
    del w3, flat, w3v, par, par3, clean_rows
    torch.cuda.empty_cache()

    n = p10_words(P10_DEPTH["hsiao"])
    words = random_words(torch, n, g, dev)
    parity = H.encode_hsiao(words)
    plain, enc_ms = timed_once(torch, lambda: H.encode_hsiao_ref(words))
    check(torch.equal(parity, plain),
          f"encode_hsiao kernel != plain version ((c)'s arena, {n} words)")
    del plain
    counts, scrub_ms = hold_hsiao_scrub(torch, dev, words, parity, g,
                                        f"(c)'s arena, {n} words")
    log(f"training shapes: encode_hsiao and scrub_hsiao over (c)'s {n}-word "
        f"arena: counts {counts.tolist()} bit-exact, doubles untouched; "
        f"plain {enc_ms:.1f} and {scrub_ms:.1f} ms; "
        f"{time.perf_counter() - t0:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del words, parity
    torch.cuda.empty_cache()


def train_args(dev, *extra):
    """`launch.train`'s CLI defaults (batch 8 x seq 256 of SyntheticLM
    seed 0, lr 3e-4, fp32 params and compute) on `dev`, plus `extra`
    flags."""
    from repro_torch.launch import train
    return train.parser().parse_args(["--device", str(dev), "--log-every",
                                      "1", "--checkpoint-every", "0", *extra])


def train_run_stats(torch, loop, args, card, what, peak):
    """Print a run's step-time median, tok/s and peak device memory beside
    the card; returns the median step seconds."""
    times = sorted(loop.monitor.times)
    med = times[len(times) // 2]
    tok_s = args.batch * args.seq / med
    log(f"{what}: step median {med:.3f} s (host clock around each step, "
        f"synchronized), {tok_s:.0f} tok/s, peak device memory "
        f"{peak / 1e9:.2f} GB on {card}")
    check(peak < 80e9, f"{what}: peak {peak / 1e9:.2f} GB")
    return med


def train_batch_loss(torch, cfg, loop, step):
    """The loss of step `step`'s batch under the loop's current params."""
    from repro_torch.models.steps import make_loss_fn
    with torch.no_grad():
        total, _ = make_loss_fn(cfg)(loop.state["params"],
                                     loop.batch_at(step))
    return float(total)


def check_losses(loop, what):
    losses = [l for _, l in loop.metrics_history]
    check(all(math.isfinite(l) for l in losses), f"{what}: loss {losses}")
    return losses


def run_train_path(torch, card, dev):
    """(a)-(c) of phase 10; returns the launch counts of its runs, each
    counted from 0 around its run (its build included: `attach_scheme`'s
    encode is the run's first launch)."""
    import gc
    t_path = time.perf_counter()
    check_train_shapes(torch, dev)
    total = {}
    for run in (train_ecc, train_compose, train_hsiao):
        for k, v in run(torch, card, dev).items():
            total[k] = total.get(k, 0) + v
        gc.collect()        # the runs' hooks close over their loops
        torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t_path:.1f} s, launches {total}")
    return total


def train_ecc(torch, card, dev):
    """(a) ecc, P10_DEPTH's layers, 12 steps, a scrub every 4 at p 1e-9, the eval
    hook at step 12."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.kernels.diag_parity.ref import encode_parity_ref
    from repro_torch.launch.engine import GenerationEngine, make_eval_hook

    steps = 12
    args = train_args(dev, "--steps", str(steps), "--ecc-scrub-every", "4",
                      "--inject-p-bit", str(P10_P_BIT), "--scheme", "ecc")
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=P10_DEPTH["ecc"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    cfg, loop, n_params = train.build(args, cfg=cfg)
    prompt = {"tokens": torch.from_numpy(SyntheticLM(
        vocab=cfg.vocab, seq_len=32, batch_per_rank=2, seed=1).batch_at(0))}
    engine = GenerationEngine(cfg, gen=8, device=dev)
    loop.eval_fn = make_eval_hook(engine, prompt)
    loop.cfg.eval_every = steps
    bits = leaf_bits(loop.state["params"])
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = f"(a) ecc, {cfg.n_layers} layers ({n_params} params)"
    log(f"{what}: {steps} steps in {wall:.1f} s, launches {counts}")
    train_run_stats(torch, loop, args, card, what, peak)
    losses = check_losses(loop, what)
    seen = [train_batch_loss(torch, cfg, loop, s) for s in (0, steps - 1)]
    log(f"(a) losses {[round(l, 4) for l in losses]}, mean of the last 4 "
        f"{sum(losses[-4:]) / 4:.4f}; under the final params step 1's "
        f"batch {seen[0]:.4f} (was {losses[0]:.4f}), step {steps}'s "
        f"{seen[1]:.4f} (was {losses[-1]:.4f})")
    check_scrub_counts(loop, bits, "(a)")
    check([s for s, _ in loop.scrub_reports] == [4, 8, 12],
          f"(a) scrubs at {[s for s, _ in loop.scrub_reports]}")
    check(counts.get("encode_parity") == steps + 1
          and counts.get("scrub") == 3, f"(a) launches {counts}")
    fresh = encode_parity_ref(loop.protected.words)
    check(torch.equal(fresh, loop.parity),
          "(a) parity after the last refresh != the plain encode")
    log(f"(a) parity after the last refresh == the plain encode of the "
        f"{loop.protected.words.numel()}-word arena, bit for bit")
    del fresh
    (hook,) = loop.eval_history
    want, _ = engine.generate(loop.state["params"], prompt)
    check(hook["step"] == steps and torch.equal(hook["tokens"], want),
          "(a) the eval hook's tokens != GenerationEngine.generate")
    log(f"(a) eval hook at step {steps}: {tuple(want.shape)} tokens == "
        f"GenerationEngine.generate on the post-scrub params")
    del want, hook, engine
    check_descent(torch, cfg, loop, steps - 1)
    return counts


#: (a)'s descent check: step lengths along the unit gradient, in L2
#: distance over all params; the first is gated
DESCENT_STEPS = (1e-5, 1e-4, 1e-3)


def check_descent(torch, cfg, loop, step, what="(a)"):
    """At the final params, one backward of step `step`'s batch: a short
    step against the gradient (DESCENT_STEPS[0] along its unit vector)
    must lower that batch's loss; the longer steps are printed.  The
    shifted params are built in the grad buffers, so the loop's params
    are not touched."""
    from repro_torch.core import tree
    from repro_torch.models.steps import _grad_leaves, make_loss_fn
    from repro_torch.optim import global_norm

    loss_fn, batch = make_loss_fn(cfg), loop.batch_at(step)
    params = loop.state["params"]
    grads = tree.map_tree(torch.zeros_like, params)
    total, _ = loss_fn(_grad_leaves(params, grads), batch)
    total.backward()
    base, norm = float(total.detach()), float(global_norm(grads))
    shifted, prev = [], None
    for eta in DESCENT_STEPS:
        for p, g in zip(tree.leaves(params), tree.leaves(grads)):
            if prev is None:            # g := p - eta * g / |g|
                g.mul_(-eta / norm).add_(p)
            else:                       # rescale the step to eta
                g.sub_(p).mul_(eta / prev).add_(p)
        prev = eta
        with torch.no_grad():
            shifted.append(float(loss_fn(grads, batch)[0]))
    log(f"{what} descent on step {step + 1}'s batch at the final params: loss "
        f"{base:.6f}, grad norm {norm:.4g}; after steps of "
        f"{', '.join(f'{e:g}' for e in DESCENT_STEPS)} against the unit "
        f"gradient {', '.join(f'{l:.6f}' for l in shifted)}")
    check(shifted[0] < base, f"{what} a step of {DESCENT_STEPS[0]:g} "
          f"against the gradient raised the loss: {base} -> {shifted[0]}")


def train_compose(torch, card, dev):
    """(b) ecc+tmr-parallel at depth 16, 8 steps, the adaptive scrub from
    the injection prior (p 1e-9 into all three copies)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    steps = 8
    args = train_args(dev, "--steps", str(steps), "--inject-p-bit",
                      str(P10_P_BIT), "--scheme", "ecc+tmr-parallel")
    cfg = get_config("phi3-mini-3.8b").replace(
        n_layers=P10_DEPTH["ecc+tmr-parallel"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    cfg, loop, n_params = train.build(args, cfg=cfg)
    loop.cfg.adaptive_scrub = True
    loop.attach_scheme()
    bits = leaf_bits(loop.state["params"])
    copies_equal = []
    refresh = loop._refresh

    def checked_refresh():
        refresh()
        w = loop.protected.words
        copies_equal.append(torch.equal(w[1], w[0])
                            and torch.equal(w[2], w[0]))

    loop._refresh = checked_refresh
    t0 = time.perf_counter()
    out = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = (f"(b) ecc+tmr-parallel, {cfg.n_layers} layers ({n_params} "
            f"params, three copies)")
    log(f"{what}: {steps} steps in {wall:.1f} s, launches {counts}")
    train_run_stats(torch, loop, args, card, what, peak)
    check_losses(loop, what)
    ctl = loop.adaptive
    scrubbed = [s for s, _ in loop.scrub_reports]
    log(f"(b) controller: interval0 {ctl.cfg.interval0}, history "
        f"{ctl.history}, scrubs at steps {scrubbed}")
    due, expect = ctl.cfg.interval0, []
    for index, _, interval in ctl.history:
        expect.append(due)
        due = index + interval
    check(scrubbed == [i for i, _, _ in ctl.history] == expect
          and scrubbed, f"(b) scrubs {scrubbed} off the schedule {expect}")
    check_scrub_counts(loop, 3 * bits, "(b)")
    mon = out["monitor"]
    check(mon["vote_disagreements"] == 0 and mon["uncorrectable"] == 0,
          f"(b) monitor {mon}")
    check(len(copies_equal) == steps and all(copies_equal),
          f"(b) copies after the refreshes: {copies_equal}")
    # the kernels at this run's shapes (after its counts were read): the
    # encode of copy 0, the vote over the three 16-layer copies and their
    # per-copy-table scrub
    w, parity3 = loop.protected.words, loop.protected.redundancy[1]
    vote = loop.scheme.tmr._vote()
    n = w.shape[1]
    check(n == p10_words(cfg.n_layers), f"(b) arena {tuple(w.shape)}")
    log_train_shape(torch, "encode_parity", f"{n} words (copy 0)",
                    lambda: loop.scheme.ecc.encode_arena(w[0]),
                    4 * n + parity3[0].numel() * 4)
    log_train_shape(torch, "tmr_vote", f"3 x {n} words",
                    lambda: vote(w[0], w[1], w[2]), 16 * n)
    log_train_shape(torch, "scrub", f"3 x {n} words, per-copy tables",
                    lambda: loop.scheme.ecc.scrub_copies(w, parity3),
                    3 * 4 * n + 2 * parity3.numel() * 4)
    return counts


def log_train_shape(torch, name, shape, fn, n_bytes):
    """Time a kernel at a training run's shape (CUDA events, after a
    warmup) beside its byte bound; on a clean store, so scrubs write
    nothing but their counts."""
    ms = time_ms(torch, fn, reps=3)
    bound, _ = bound_ms(n_bytes)
    log(f"training shape: {name} over {shape}: {ms:.3f} ms, byte bound "
        f"{bound:.3f} ms ({100 * bound / ms:.0f}%)")


def train_hsiao(torch, card, dev):
    """(c) hsiao with microbatches 2 and the int8 compression at depth 2:
    checkpoints every 2 steps, preempted at step 3, restored in a fresh
    loop, a planted double error after the step-4 checkpoint."""
    import shutil
    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import train

    import gc
    ckpt_dir = ROOT / "build" / "phase10_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=P10_DEPTH["hsiao"])
    common = ("--steps", "6", "--scheme", "hsiao", "--microbatches", "2",
              "--grad-compression")
    args = train_args(dev, *common, "--ecc-scrub-every", "1", "--ckpt-dir",
                      str(ckpt_dir), "--checkpoint-every", "2")
    saved, logs = {}, []

    def host(loop):
        """The state, parity and step as host tensors (what a save
        holds)."""
        snap = {"state": loop.state, "parity": loop.parity}
        return tree.map_tree(lambda x: x.detach().to("cpu", copy=True),
                             snap)

    def watch(loop):
        save, restore = loop.save, loop.restore

        def watched_save():
            saved[loop.step] = host(loop)
            save()

        def watched_restore():
            ok = restore()
            want = saved[loop.step]
            got = host(loop)
            same = all(a.dtype == b.dtype and a.shape == b.shape
                       and torch.equal(a.reshape(-1).view(torch.uint8),
                                       b.reshape(-1).view(torch.uint8))
                       for a, b in zip(tree.leaves(got), tree.leaves(want)))
            check(tree.paths(got) == tree.paths(want) and same,
                  f"(c) the state restored at step {loop.step} != saved")
            log(f"(c) restored step {loop.step}: params, m, v, count, err "
                f"and parity equal the saved state bit for bit")
            return ok

        loop.save, loop.restore = watched_save, watched_restore
        loop.log = lambda msg: (logs.append(msg), log(f"(c) {msg}"))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, loop, n_params = train.build(args, cfg=cfg)
    watch(loop)
    try:
        loop.run(fail_at=3)
        check(False, "(c) the run was not preempted")
    except RuntimeError as e:
        log(f"(c) {e}")
    loop.ckpt.wait()          # the step-2 snapshot's async write
    del loop
    gc.collect()              # its watched hooks close over it
    torch.cuda.empty_cache()
    # a fresh process: no scheme attached until the restore re-arms it
    fresh = train_args(dev, *common, "--ecc-scrub-every", "0")
    cfg, loop, _ = train.build(fresh, cfg=cfg)
    loop.ckpt = Checkpointer(str(ckpt_dir), keep=2)
    loop.cfg.checkpoint_every, loop.cfg.scrub_every = 2, 1
    watch(loop)
    check(loop.protected is None, "(c) the fresh loop is armed already")
    check(loop.restore() and loop.step == 2, "(c) restore from step 2")
    check(loop.scheme is not None and loop.scheme.name == "hsiao"
          and loop.protected is not None, "(c) the scheme is not re-armed")
    fired = []

    def plant(params, step):
        # two flips in one word (so in one 32-word block) after the step-4
        # checkpoint: Hsiao detects the double and cannot correct it
        if step == 5 and not fired:
            fired.append(step)
            u = params["layers"]["mlp"]["w_up"].view(torch.int32).view(-1)
            u[12345] ^= (1 << 3) | (1 << 17)
        return params

    loop.inject_fn = plant
    out = loop.run()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = f"(c) hsiao, {cfg.n_layers} layers ({n_params} params)"
    log(f"{what}: preempted, restored and resumed in {wall:.1f} s "
        f"(checkpoint writes and reads included), launches {counts}")
    train_run_stats(torch, loop, args, card, what, peak)
    check(fired == [5] and any("uncorrectable" in l for l in logs)
          and any("resumed from step 4" in l for l in logs)
          and out["monitor"]["uncorrectable"] == 1,
          f"(c) the planted double: fired {fired}, monitor {out['monitor']}")
    check(out["final_step"] == 6 and all(
        bool(torch.isfinite(x).all()) for x in tree.leaves(
            loop.state["params"])), f"(c) final {out['final_step']}")
    resumed = check_losses(loop, what)[-1]
    words, parity = loop.protected.words, loop.parity
    n = words.numel()
    check(n == p10_words(cfg.n_layers), f"(c) arena {n} words")
    log_train_shape(torch, "encode_hsiao", f"{n} words",
                    lambda: loop.scheme.encode_arena(words),
                    4 * n + parity.numel() * 4)
    log_train_shape(torch, "scrub_hsiao", f"{n} words",
                    lambda: loop.scheme.scrub_arena(words, parity),
                    4 * n + parity.numel() * 4)
    del loop, words, parity
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # the same six steps, uninterrupted
    cfg, plain, _ = train.build(train_args(dev, *common, "--ecc-scrub-every",
                                           "1"), cfg=cfg)
    plain.run()
    whole = check_losses(plain, "(c) uninterrupted")[-1]
    # the path is deterministic (the same batches, seeds and launches), so
    # a restore that lost any state shows as a different loss
    log(f"(c) step-6 loss: resumed {resumed!r}, uninterrupted {whole!r}")
    check(resumed == whole, f"(c) step-6 loss {resumed!r} != {whole!r}")
    return counts


def check_small_training(torch, dev):
    """One smoke-width train step under ecc (scrubbed after the step) on
    the card and on the CPU's plain path from the same params (std 0.02)
    and batch:
    loss and grad norm within 1e-5 and 1e-4, the params within 1e-5 of
    each leaf's largest value but for elements whose grads are within
    rounding of zero (Adam's first step moves an element by about lr
    whatever its grad: at most 1e-3 of them, by at most 2.5 lr), and the
    card's parity equal to the plain encode of the card's params, bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.core import arena, tree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.diag_parity.ref import encode_parity_ref
    from repro_torch.models import params as P
    from repro_torch.models import transformer as TR
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.reliability import parse_scheme
    from repro_torch.runtime import LoopConfig, TrainLoop

    cfg = get_config("phi3-mini-3.8b").smoke().replace(
        compute_dtype="float32")
    # weights at std 0.02: the fan-in init of the stacked layers (std
    # 1/sqrt(2) here) makes the model amplify rounding, so that two
    # devices' grads would differ by 1e-4 (ROADMAP C, training)
    gen = torch.Generator().manual_seed(SEED)
    host = P.materialize(TR.model_specs(cfg), gen)
    for x in tree.leaves(host):
        if bool(x.any()):
            x.normal_(0.0, 0.02, generator=gen)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch_per_rank=4)
    opt = AdamWConfig(total_steps=1, warmup_steps=5)
    out = []
    for device in (dev, torch.device("cpu")):
        words, spec = arena.words_of(host)
        params = arena.unpack(words.clone().to(device), spec)
        step = make_train_step(cfg, opt)
        metrics = {}

        def train_step(state, batch, step=step, metrics=metrics):
            state, m = step(state, batch)
            metrics.update(m)
            return state, m

        loop = TrainLoop(train_step, init_train_state(params),
                         lambda s, device=device: {"tokens": torch.from_numpy(
                             data.batch_at(s)).to(device)},
                         LoopConfig(total_steps=1, checkpoint_every=0,
                                    scrub_every=1, log_every=1,
                                    scheme=parse_scheme("ecc")),
                         log=lambda *_: None)
        loop.attach_scheme()
        loop.run()
        out.append((loop, {k: float(v) for k, v in metrics.items()}))
    (card, mk), (cpu, mp) = out
    check(all(int(v) == 0 for v in card.scrub_reports[0][1]),
          f"small training: scrub {card.scrub_reports[0][1]}")
    check(abs(mk["loss"] - mp["loss"]) <= 1e-5 * abs(mp["loss"])
          and abs(mk["grad_norm"] - mp["grad_norm"])
          <= 1e-4 * mp["grad_norm"], f"small training: {mk} vs {mp}")
    n_off = n_all = 0
    worst = 0.0
    for a, b in zip(tree.leaves(card.state["params"]),
                    tree.leaves(cpu.state["params"])):
        a = a.cpu()
        tol = 1e-5 * float(b.abs().max())
        n_off += int(((a - b).abs() > tol).sum())
        n_all += b.numel()
        worst = max(worst, float((a - b).abs().max()))
    lr = mp["lr"]
    check(n_off <= 1e-3 * n_all and worst <= 2.5 * lr,
          f"small training: {n_off} of {n_all} params off, worst {worst}")
    parity = encode_parity_ref(card.protected.words.cpu())
    check(torch.equal(parity, card.parity.cpu()),
          "small training: the card's parity != the plain encode")
    log(f"small reference training step (phi3 smoke, fp32, ecc): loss "
        f"{mk['loss']:.6f} vs {mp['loss']:.6f} on the CPU, grad norm "
        f"{mk['grad_norm']:.6f} vs {mp['grad_norm']:.6f}, {n_off} of "
        f"{n_all} params beyond 1e-5 of their leaf's scale (worst "
        f"{worst:.3g}, lr {lr:.3g}), parity == the plain encode")


# ----------------------------------------------------------------------------
# 11. the dense zoo and the MoE family
# ----------------------------------------------------------------------------

#: phase 11's configs, cut in depth only: (arch, layers)
P11_MOE = ("phi3.5-moe-42b-a6.6b", 3)
P11_ZOO = (("qwen2.5-14b", 20), ("nemotron-4-15b", 10), ("deepseek-67b", 8))
P11_QWEN_FULL = ("qwen2.5-14b", 48)
#: the weights' soft-error rate (every held copy) of the protected runs
P11_P_BIT = 1e-9
#: phase 4's one-shot peaks over its 15.29 GB copy (16.01, 32.07 and 62.78
#: GB): the reckoning of each run's peak from its config's copy
P4_PEAK_RATIO = {"off": 1.05, "ecc": 2.10, "ecc+tmr-parallel": 4.11}
#: the flash shapes the phase's prefills give the kernel: (what, B, S, H,
#: KV, hd), bf16, causal
P11_FLASH = (("phi3.5-moe prefill", 4, 256, 32, 8, 128),
             ("phi3.5-moe admission", 1, 256, 32, 8, 128),
             ("llama4-maverick prefill on a 4x1 rank", 1, 256, 40, 8, 128),
             ("qwen2.5-14b prefill", 4, 256, 40, 8, 128),
             ("nemotron-4-15b prefill", 4, 256, 48, 8, 128),
             ("deepseek-67b prefill", 4, 256, 64, 8, 128))


def p11_config(arch: str, depth: int):
    from repro_torch.configs import get_config
    return get_config(arch).replace(n_layers=depth, attention_impl="pallas")


def p11_copy_bytes(cfg) -> int:
    from repro_torch.models import transformer as T
    from repro_torch.models.params import count_params
    return 4 * count_params(T.model_specs(cfg))


def reckon(cfg, schemes, what="", phase="11"):
    """Log a config's fp32 copy and each scheme's peak reckoned from it."""
    copy = p11_copy_bytes(cfg) / 1e9
    log(f"phase {phase}{what}: {cfg.name} at {cfg.n_layers} of its layers: "
        f"a copy is {copy:.2f} GB; reckoned peaks " + ", ".join(
            f"{s} {P4_PEAK_RATIO[s] * copy:.1f} GB" for s in schemes))


def check_flash_zoo(torch, dev, shapes=None):
    """Flash against its plain version at the phase's hd=128 GQA shapes
    (or `shapes`), timed with SDPA beside it (not counted as the path's
    launches)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    worst = 0.0
    for what, B, S, H, KV, hd in shapes or P11_FLASH:
        q, k, v = (torch.randn((B, S, h, hd), device=dev, generator=g)
                   .to(torch.bfloat16) for h in (H, KV, KV))
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True)
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= 1e-2 + 1e-2 * want.float().abs()).all()),
              f"flash at {what}: kernel != plain (max abs err "
              f"{diff.max().item():.3g})")
        worst = max(worst, diff.max().item())
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fns = {"kernel": lambda: flash_attention(q, k, v, causal=True),
               "plain": lambda: flash_attention_ref(q, k, v, causal=True),
               "SDPA": lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, is_causal=True, enable_gqa=True)}
        dev_ms = {name: graph_ms(torch, fn) for name, fn in fns.items()}
        call_ms = {name: time_ms(torch, fn, reps=20)
                   for name, fn in fns.items()}
        pairs = S * (S + 1) // 2
        bnd = bound_ms(2 * B * S * (2 * H + 2 * KV) * hd,
                       4 * B * H * hd * pairs, "bf16")
        log(f"flash_attention at {what}: B={B} S={S} H={H} KV={KV} hd={hd} "
            f"bf16 causal: " + ", ".join(
                f"{name} {dev_ms[name]:.4f} ms (per call "
                f"{call_ms[name]:.4f})" for name in fns)
            + f"; bound {bnd[0]:.4f} ms ({bnd[1]}); max abs err "
            f"{diff.max().item():.3g}")
        del q, k, v, qh, kh, vh, got, want, diff
    return worst


def time_zoo_shapes(torch, dev):
    """Phase 11's block-code and vote launches at its own shapes, timed
    (CUDA events; the small shapes by CUDA-graph replay) beside their
    bounds and, where the temporaries fit beside the operands, their plain
    versions: encode_parity and scrub over the smallest and largest zoo
    arena (phi3.5-moe at 3 layers, deepseek-67b at 8), scrub over
    phi3.5-moe's three copies against one table (the ecc+tmr launch),
    encode_parity over a tick's pages and inject_scrub over a pool copy
    of phi3.5-moe's server, tmr_vote over its KV cache.  Not counted as
    the path's launches."""
    from repro_torch.kernels import diag_parity as D
    from repro_torch.kernels.inject_scrub import (inject_scrub,
                                                  inject_scrub_ref)
    from repro_torch.kernels.tmr_vote import vote, vote_ref
    from repro_torch.models import transformer as T
    from repro_torch.models.params import layout

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    moe = p11_config(*P11_MOE)

    def arena_words(cfg):
        return layout(T.model_specs(cfg), cfg.param_dtype).n_words

    for cfg in (moe, p11_config(*P11_ZOO[2])):
        n = arena_words(cfg)
        words = random_words(torch, n, g, dev)
        parity = D.encode_parity(words)
        enc_ms = time_ms(torch, lambda: D.encode_parity(words), reps=3)
        scrub_ms = time_ms(torch, lambda: D.scrub(words, parity), reps=3)
        plain = "not measured (temporaries past the card beside the arena)"
        if cfg is moe:
            (pe, enc_plain), (ps, scrub_plain) = (
                timed_once(torch, lambda: D.encode_parity_ref(words)),
                timed_once(torch, lambda: D.scrub_ref(words, parity)))
            check(torch.equal(pe, parity), "zoo arena: encode != plain")
            plain = f"plain {enc_plain:.1f} / {scrub_plain:.1f} ms"
            del pe, ps
        log(f"zoo shapes: {cfg.name} at {cfg.n_layers} layers, {n} words: "
            f"encode_parity {enc_ms:.3f} ms, scrub {scrub_ms:.3f} ms (clean "
            f"arena), bounds {bound_ms(n * 4 + n // 32 * 12, 6 * n)[0]:.3f}"
            f" / {bound_ms(n * 4 + n // 32 * 12, 8 * n)[0]:.3f} ms; {plain}")
        del words, parity
        torch.cuda.empty_cache()

    n = arena_words(moe)
    w3 = torch.empty(3 * n, dtype=torch.int32, device=dev)
    w3[:n] = random_words(torch, n, g, dev)
    par = D.encode_parity(w3[:n])
    w3[n:2 * n] = w3[:n]
    w3[2 * n:] = w3[:n]
    ms = time_ms(torch, lambda: D.scrub(w3, par), reps=3)
    log(f"zoo shapes: scrub over phi3.5-moe's three copies ({3 * n} words, "
        f"one table, the ecc+tmr launch): {ms:.3f} ms, bound "
        f"{bound_ms(3 * n * 4 + n // 32 * 12, 8 * 3 * n)[0]:.3f} ms; plain "
        f"not measured (temporaries past the card beside the copies)")
    del w3, par
    torch.cuda.empty_cache()

    kv = tuple(torch.randn((3, 4, 288, moe.n_kv, moe.head_dim), device=dev,
                           generator=g).to(torch.bfloat16) for _ in range(3))
    ms, call_ms = small_shape_ms(torch, lambda: vote(*kv))
    plain_ms = time_ms(torch, lambda: vote_ref(*kv), reps=20)
    nbytes = kv[0].numel() * 2
    log(f"zoo shapes: tmr_vote over phi3.5-moe's KV cache "
        f"{tuple(kv[0].shape)} bf16: {ms:.4f} ms (per call {call_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, bound "
        f"{bound_ms(4 * nbytes, 5 * kv[0].numel() / 2)[0]:.4f} ms")
    del kv

    n_pool, n_page = server_pool_words(moe)
    pages = random_words(torch, n_page, g, dev)
    ms, call_ms = small_shape_ms(torch, lambda: D.encode_parity(pages))
    plain_ms = time_ms(torch, lambda: D.encode_parity_ref(pages), reps=5)
    log(f"zoo shapes: encode_parity over a tick's pages of phi3.5-moe's "
        f"pool ({n_page} words): {ms:.4f} ms (per call {call_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, bound "
        f"{bound_ms(n_page * 4 + n_page // 32 * 12, 6 * n_page)[0]:.4f} ms")
    pool = random_words(torch, n_pool, g, dev)
    ppar = D.encode_parity(pool)
    mask = torch.zeros_like(pool)       # the timed pass: nothing to repair
    ms, call_ms = small_shape_ms(torch, lambda: inject_scrub(pool, ppar,
                                                             mask))
    plain_ms = time_ms(torch, lambda: inject_scrub_ref(pool, ppar, mask),
                       reps=5)
    log(f"zoo shapes: inject_scrub over phi3.5-moe's pool copy ({n_pool} "
        f"words): {ms:.4f} ms (per call {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, bound "
        f"{bound_ms(2 * n_pool * 4 + n_pool // 32 * 12, 10 * n_pool)[0]:.4f}"
        f" ms")
    del pages, pool, ppar, mask
    torch.cuda.empty_cache()


def count_drops(torch, cfg, params, tokens):
    """Capacity drops of one prefill and one decode step, recorded around
    the MoE dispatch: [(tokens routed, capacity, drops)] a MoE layer."""
    from repro_torch.models import moe
    from repro_torch.models.steps import make_decode_step, make_prefill_step

    real, seen = moe.dispatch, []

    def spy(expert_idx, n_experts, capacity):
        out = real(expert_idx, n_experts, capacity)
        seen.append((expert_idx.shape[1], capacity, (~out[3]).sum()))
        return out

    moe.dispatch = spy
    try:
        with torch.no_grad():
            tok, _, cache = make_prefill_step(cfg, tokens.shape[1] + 1)(
                params, {"tokens": tokens})
            make_decode_step(cfg)(params, tok, cache)
    finally:
        moe.dispatch = real
    return [(t, c, int(d)) for t, c, d in seen]


def run_zoo_path(torch, card, dev):
    """(a)-(d) of phase 11; returns the launch counts of its runs, each
    counted from 0 around its run."""
    import gc
    t_path = time.perf_counter()
    torch.cuda.empty_cache()
    time_zoo_shapes(torch, dev)
    err = check_flash_zoo(torch, dev)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    add(run_moe_one_shot(torch, card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    add(run_dense_zoo(torch, card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    check_llama4_smoke(torch, dev)
    log(f"phase 11: {time.perf_counter() - t_path:.1f} s, launches {total}, "
        f"flash max abs err {err:.3g} at hd=128")
    return total


def check_launched(counts, names, what):
    for name in names:
        check(counts.get(name, 0) > 0, f"{what}: {name} never launched")


def run_moe_one_shot(torch, card, dev):
    """(a) phi3.5-moe at full width, 3 layers, under off, ecc and
    ecc+tmr-parallel --vote-every 8 --vote-cache at p_bit 1e-9; (b) its
    server under off and ecc with the pool inject_scrubbed every tick."""
    from repro_torch.core import arena
    from repro_torch.launch.serve import make_inputs

    cfg = p11_config(*P11_MOE)
    schemes = ("off", "ecc", "ecc+tmr-parallel")
    reckon(cfg, schemes, " (a)")
    t0 = time.perf_counter()
    inputs = make_inputs(cfg, batch=4, prompt_len=256, seed=SEED, device=dev)
    torch.cuda.synchronize()
    params, tokens = inputs["params"], inputs["tokens"]
    clean, spec = arena.words_of(params)
    log(f"phase 11 (a): {cfg.name}: random init in "
        f"{time.perf_counter() - t0:.1f}s, {spec.n_words} arena words "
        f"({cfg.moe_experts} experts top-{cfg.moe_topk}, expert d_ff "
        f"{cfg.moe_dff}, d_model {cfg.d_model}, vocab {cfg.vocab}) on {card}")
    runs = [("off", 0.0, {}), ("ecc", P11_P_BIT, {}),
            ("ecc+tmr-parallel", P11_P_BIT,
             dict(vote_every=8, vote_cache=True))]
    clean_tokens, total = None, {}
    for spec_s, p_bit, kw in runs:
        out, counts = serve_and_check(torch, cfg, params, tokens, clean,
                                      spec_s, p_bit, kw, clean_tokens)
        need = ["flash_attention"]
        if spec_s != "off":
            need += ["encode_parity", "scrub"]
        if "tmr" in spec_s:
            need.append("tmr_vote")
        check_launched(counts, need, f"phase 11 (a) {spec_s}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        clean_tokens = out if clean_tokens is None else clean_tokens
    drops = count_drops(torch, cfg, params, tokens)
    log(f"phase 11 (a): capacity drops a MoE layer (tokens routed, C, "
        f"dropped top-{cfg.moe_topk} assignments): prefill "
        f"{drops[:P11_MOE[1]]}, one decode step {drops[P11_MOE[1]:]}")
    check(all(d == 0 for _, _, d in drops[P11_MOE[1]:]),
          "phase 11 (a): a decode step dropped tokens")
    server, _ = run_server_path(
        torch, cfg, params, runs=[("off", 0.0, None, 0),
                                  ("ecc", P11_P_BIT, "inject_scrub", 0)],
        what="phase 11 (b) ")
    for k, v in server.items():
        total[k] = total.get(k, 0) + v
    return total


def run_dense_zoo(torch, card, dev):
    """(c) qwen2.5-14b, nemotron-4-15b and deepseek-67b cut in depth under
    off and ecc at p_bit 1e-9, then qwen2.5-14b at full depth under off."""
    from repro_torch.core import arena
    from repro_torch.launch.serve import make_inputs

    total = {}
    for (arch, depth), schemes in [(z, ("off", "ecc")) for z in P11_ZOO] \
            + [(P11_QWEN_FULL, ("off",))]:
        cfg = p11_config(arch, depth)
        reckon(cfg, schemes, " (c)")
        t0 = time.perf_counter()
        inputs = make_inputs(cfg, batch=4, prompt_len=256, seed=SEED,
                             device=dev)
        torch.cuda.synchronize()
        clean, spec = arena.words_of(inputs["params"])
        log(f"phase 11 (c): {cfg.name}: random init in "
            f"{time.perf_counter() - t0:.1f}s, {spec.n_words} arena words")
        clean_tokens = None
        for s in schemes:
            out, counts = serve_and_check(
                torch, cfg, inputs["params"], inputs["tokens"], clean, s,
                0.0 if s == "off" else P11_P_BIT, {}, clean_tokens)
            check_launched(counts, ["flash_attention"] + (
                ["encode_parity", "scrub"] if s != "off" else []),
                f"phase 11 (c) {cfg.name} {s}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            clean_tokens = out if clean_tokens is None else clean_tokens
        del inputs, clean, clean_tokens, out
        torch.cuda.empty_cache()
    return total


def check_llama4_smoke(torch, dev):
    """(d) llama4-maverick's smoke config (interleaved dense/MoE layers,
    top-1 routing, the shared expert) in fp32: the card's kernel path
    against the CPU's plain path on the same weights: tokens equal, logits
    within 1e-4, the aux loss within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.core import arena
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models import transformer as T
    from repro_torch.models.steps import make_decode_step, make_prefill_step

    base = get_config("llama4-maverick-400b-a17b").smoke().replace(
        compute_dtype="float32")
    inputs = make_inputs(base, batch=2, prompt_len=32, seed=SEED,
                         device="cpu")
    words, spec = arena.words_of(inputs["params"])
    outs = []
    for where, attn in ((dev, "pallas"), (torch.device("cpu"), "naive")):
        cfg = base.replace(attention_impl=attn)
        params = arena.unpack(words.to(where), spec)
        tokens = inputs["tokens"].to(where)
        with torch.no_grad():
            _, aux = T.forward(params, cfg, {"tokens": tokens})
            tok, logits, cache = make_prefill_step(cfg, 40)(
                params, {"tokens": tokens})
            toks, lgs = [tok], [logits]
            for _ in range(8):
                tok, logits, cache = make_decode_step(cfg)(params, tok, cache)
                toks.append(tok)
                lgs.append(logits)
        outs.append((torch.cat(toks, 1).cpu(), torch.stack(lgs).cpu(),
                     float(aux)))
    (tk, lk, ak), (tp, lp, ap) = outs
    check(torch.equal(tk, tp), "phase 11 (d): llama4 smoke tokens differ "
          "between the card and the CPU")
    err = (lk - lp).abs().max().item()
    check(err <= 1e-4, f"phase 11 (d): llama4 smoke logits differ by "
          f"{err:.3g}")
    check(abs(ak - ap) <= 1e-6, f"phase 11 (d): aux {ak} != {ap}")
    log(f"phase 11 (d): llama4 smoke (moe_every 2, top-1, shared expert), "
        f"fp32: card == CPU, tokens {tk[0].tolist()}; logits max abs err "
        f"{err:.3g}; aux {ak:.7f} / {ap:.7f}")


# ----------------------------------------------------------------------------
# 12. the SSM, hybrid, VLM and enc-dec families
# ----------------------------------------------------------------------------

#: the weights' soft-error rate (every held copy) of the protected runs
P12_P_BIT = 1e-9
#: the flash shapes phase 12's prefills give the kernel: (what, B, Sq, Sk,
#: H, KV, hd, causal, window); cross-attention's k and v are views of one
#: projected (B, Sk, 2 KV hd) tensor, as `cross_attention` makes them
P12_FLASH = (
    ("recurrentgemma-2b local attention", 4, 256, 256, 10, 1, 256, True,
     2048),
    ("recurrentgemma-2b past its window", 1, 3072, 3072, 10, 1, 256, True,
     2048),
    ("llama-3.2-vision cross-attention", 4, 256, 1600, 32, 8, 128, False,
     0),
    ("seamless encoder", 4, 256, 256, 16, 16, 64, False, 0),
    ("seamless decoder", 4, 256, 256, 16, 16, 64, True, 0),
    ("seamless cross-attention", 4, 256, 256, 16, 16, 64, False, 0),
)
#: llama-3.2-vision's depth under each scheme: full depth (39.1 GB a copy)
#: only where the reckoned peak stays under 80 GB
P12_VLM_DEPTH = {"off": 40, "ecc": 20, "ecc+tmr-parallel": 10}
#: phase 10 (a)'s training peak over its fp32 copy (64.90 / 15.29 GB)
P10_PEAK_RATIO = 4.24
#: (f)'s configs, cut in depth only: (arch, layers or None for all)
P12_TRAIN = (("recurrentgemma-2b", None), ("llama-3.2-vision-11b", 5),
             ("seamless-m4t-medium", None))
#: the teacher-forcing gate, both sides in fp32 at weights of std 0.02:
#: |decode-step logit - forward logit| <= TF_TOL x the largest |forward
#: logit| (two algorithms, the chunked SSD scan or the doubling RG-LRU
#: scan against the step recurrence, and the ring cache against windowed
#: attention, summed in other orders over 24 to 26 layers)
TF_TOL = 1e-3


def p12_config(arch: str, depth=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(attention_impl="pallas")
    return cfg if depth is None else cfg.replace(n_layers=depth)


def flash_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the mask keeps (query i at position i)."""
    total = 0
    for i in range(Sq):
        hi = min(Sk, i + 1) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_bf16_tolerance(want):
    """Per-element bound on |bf16 kernel - plain| at phase 12's shapes: an
    ulp of the output (2^-7 |plain|) plus P's rounding, which scales with
    the largest output (2^-8 max|plain|); one kv tile dropped or counted
    twice breaks it (tests/test_torch_flash_attention.py)."""
    mag = want.float().abs()
    return 2 ** -7 * mag + 2 ** -8 * mag.max()


def check_flash_families(torch, dev):
    """Flash against its plain version at phase 12's shapes, in bf16
    (`flash_bf16_tolerance`) and fp32 (2e-5 + 2e-5 |plain|: the same math
    summed in another order), the bf16 kernel timed with SDPA beside it
    (not counted as the path's launches)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    for what, B, Sq, Sk, H, KV, hd, causal, window in P12_FLASH:
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, Sq, H, hd), device=dev, generator=g)
            kv = torch.randn((B, Sk, 2 * KV * hd), device=dev, generator=g)
            q, kv = q.to(dtype), kv.to(dtype)
            k = kv[..., :KV * hd].reshape(B, Sk, KV, hd)
            v = kv[..., KV * hd:].reshape(B, Sk, KV, hd)
            if "cross" not in what:
                k, v = k.contiguous(), v.contiguous()
            kw = dict(causal=causal, window=window)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            diff = (got.float() - want.float()).abs()
            tol = (flash_bf16_tolerance(want) if dtype == torch.bfloat16
                   else 2e-5 + 2e-5 * want.float().abs())
            ok = bool((diff <= tol).all())
            errs[dtype] = (diff.max().item(), (diff / tol).max().item(),
                           want.float().abs().max().item())
            check(ok, f"flash at {what} ({dtype}): kernel != plain (max abs "
                  f"err {errs[dtype][0]:.3g}, {errs[dtype][1]:.3g} of its "
                  f"tolerance)")
            del got, want, diff, tol
            if dtype == torch.float32:
                continue
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if window:
                i = torch.arange(Sq, device=dev)[:, None]
                j = torch.arange(Sk, device=dev)[None, :]
                mask = (j <= i) & (j > i - window)
            fns = {"kernel": lambda: flash_attention(q, k, v, **kw),
                   "plain": lambda: flash_attention_ref(q, k, v, **kw),
                   "SDPA": lambda: F.scaled_dot_product_attention(
                       qh, kh, vh, attn_mask=mask,
                       is_causal=causal and mask is None,
                       enable_gqa=KV != H)}
            dev_ms = {name: graph_ms(torch, fn, reps=10 if Sq > 1024
                                     else 50) for name, fn in fns.items()}
            call_ms = {name: time_ms(torch, fn, reps=10)
                       for name, fn in fns.items()}
            pairs = flash_pairs(Sq, Sk, causal, window)
            bnd = bound_ms(2 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd),
                           4 * B * H * hd * pairs, "bf16")
            log(f"flash_attention at {what}: B={B} Sq={Sq} Sk={Sk} H={H} "
                f"KV={KV} hd={hd} {'causal' if causal else 'full'}"
                f"{f' window={window}' if window else ''} bf16: " + ", ".join(
                    f"{name} {dev_ms[name]:.4f} ms (per call "
                    f"{call_ms[name]:.4f})" for name in fns)
                + f"; bound {bnd[0]:.4f} ms ({bnd[1]}, {pairs} pairs)")
            del q, k, v, kv, qh, kh, vh, mask
        log(f"flash_attention at {what}: max abs err " + ", ".join(
            f"{name} {errs[dt][0]:.3g} ({errs[dt][1]:.3g} of its tolerance, "
            f"max |plain| {errs[dt][2]:.3g})" for name, dt in
            (("bf16", torch.bfloat16), ("fp32", torch.float32))))
    torch.cuda.empty_cache()


def open_gates(torch, params) -> int:
    """Set every cross-attention ``gate`` and the VLM's ``gate_mlp`` to 1.0
    in place (they initialise to zero, and tanh(0) would zero the whole
    cross path); returns the leaves set."""
    from repro_torch.core import tree
    n = 0
    for path, x in zip(tree.paths(params), tree.leaves(params)):
        if path[-1] in ("gate", "gate_mlp"):
            x.fill_(1.0)
            n += 1
    return n


def p12_inputs(torch, cfg, batch, prompt_len, dev, what):
    """make_inputs (params, tokens, the modality input) with every gate
    open; returns the inputs and the clean arena words."""
    from repro_torch.core import arena
    from repro_torch.launch.serve import make_inputs
    t0 = time.perf_counter()
    inputs = make_inputs(cfg, batch=batch, prompt_len=prompt_len, seed=SEED,
                         device=dev)
    gates = open_gates(torch, inputs["params"])
    torch.cuda.synchronize()
    clean, spec = arena.words_of(inputs["params"])
    n = spec.n_words
    log(f"phase 12 {what}: {cfg.name} at {cfg.n_layers} layers: random init "
        f"in {time.perf_counter() - t0:.1f}s, {n} arena words "
        f"({n * 4 / 1e9:.2f} GB; an encode's or one copy's scrub's byte "
        f"bound {bound_ms(n * 4 + n // 32 * 12)[0]:.3f} ms), {gates} gate "
        f"leaves at 1.0, modality "
        f"{[tuple(v.shape) for v in inputs['modality'].values()]}")
    return inputs, clean


def p12_serve(torch, cfg, inputs, clean, runs, what):
    """serve_and_check over `runs` [(scheme, kw)] at batch x prompt of
    `inputs`, protected schemes at P12_P_BIT, TTFT from 8-step chunks;
    returns (the first run's tokens, the summed launch counts)."""
    from repro_torch import kernels
    total, clean_tokens = {}, None
    for spec_s, kw in runs:
        p_bit = 0.0 if spec_s == "off" else P12_P_BIT
        out, counts = serve_and_check(
            torch, cfg, inputs["params"], inputs["tokens"], clean, spec_s,
            p_bit, dict(kw, chunk=8), clean_tokens,
            modality=inputs["modality"])
        shapes = {k[1]: v for k, v in kernels.launch_shapes().items()
                  if k[0] == "flash_attention"}
        if shapes:
            log(f"phase 12 {what} {spec_s}: flash launches by shape {shapes}")
        if "tmr" in spec_s:
            nbytes, leaves = cache_size(cfg, inputs)
            log(f"phase 12 {what} {spec_s}: a cache vote reads three copies "
                f"and writes one of {nbytes / 1e6:.2f} MB over {leaves} "
                f"leaves: byte bound {bound_ms(4 * nbytes)[0]:.4f} ms")
        need = ["flash_attention"] if cfg.family != "ssm" else []
        if spec_s != "off":
            need += ["encode_parity", "scrub"]
        if "tmr" in spec_s:
            need.append("tmr_vote")
        check_launched(counts, need, f"phase 12 {what} {spec_s}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        clean_tokens = out if clean_tokens is None else clean_tokens
    return clean_tokens, total


def conditioned_params(torch, cfg, dev):
    """Weights at std 0.02 (the specs' zeros and ones kept, every gate at
    1.0), the CPU tests' draw.  At the reference's fan-in init a third of
    the RG-LRU's a_t round to within an ulp of 1, where sqrt(1 - a_t^2)
    keeps no correct digit in fp32, and 26 layers amplify that: two
    algorithms' logits cannot be held to each other there, nor can the
    reference's compiled and op-by-op runs (ROADMAP C)."""
    from repro_torch.core import tree
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    specs = T.model_specs(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    params = P.materialize(specs, g, cfg.param_dtype, dev)
    for s, x in zip(tree.leaves(specs), tree.leaves(params)):
        if s.init not in ("zeros", "ones"):
            x.normal_(0.0, 0.02, generator=g)
    open_gates(torch, params)
    return params


def teacher_forcing_error(torch, cfg, params, batch, tokens):
    """(max |decode logit - forward logit|, max |forward logit|, share of
    equal greedy ids) with `tokens` fed back through `decode_step` from
    the prompt's prefill, against `forward` over prompt + tokens."""
    from repro_torch.models import transformer as T
    from repro_torch.models.steps import (head_weights, make_decode_step,
                                          make_prefill_step)
    S, G = batch["tokens"].shape[1], tokens.shape[1]
    with torch.no_grad():
        _, lg, cache = make_prefill_step(cfg, S + G)(params, batch)
        steps, dec = [lg], make_decode_step(cfg)
        for i in range(G - 1):
            _, lg, cache = dec(params, tokens[:, i:i + 1], cache)
            steps.append(lg)
        del cache
        got = torch.cat(steps, 1)
        ext = dict(batch, tokens=torch.cat([batch["tokens"],
                                            tokens[:, :-1]], 1))
        h, _ = T.forward(params, cfg, ext)
        want = (h[:, S - 1:] @ head_weights(params, cfg)).float()
        del h
    return ((got - want).abs().max().item(), want.abs().max().item(),
            (got.argmax(-1) == want.argmax(-1)).float().mean().item())


def cache_size(cfg, inputs):
    """(bytes, leaves) of the decode cache of a 32-token generation from
    `inputs` (`cache_specs`, unpinned leaves in the compute dtype)."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as T
    B, S = inputs["tokens"].shape
    mem = [v.shape[1] for v in inputs["modality"].values()]
    leaves = tree.leaves(T.cache_specs(cfg, B, S + 32, mem[0] if mem else 0))
    return sum(math.prod(s.shape) * s.resolved_dtype(
        cfg.compute_dtype).itemsize for s in leaves), len(leaves)


def check_teacher_forcing(torch, cfg, inputs, tokens, what):
    """The run's generated tokens fed back through the decode steps give
    the logits `forward` gives over prompt + tokens, both in fp32, within
    TF_TOL of the largest: gated at weights of std 0.02
    (`conditioned_params`), and at the run's own weights (the reference's
    fan-in init) too unless the model has RG-LRU layers, whose figure
    there is printed, not gated (see `conditioned_params`)."""
    c32 = cfg.replace(compute_dtype="float32")
    batch = {"tokens": inputs["tokens"], **inputs["modality"]}
    S, G = inputs["tokens"].shape[1], tokens.shape[1]
    t0 = time.perf_counter()
    params = conditioned_params(torch, c32, inputs["tokens"].device)
    err, scale, same = teacher_forcing_error(torch, c32, params, batch,
                                             tokens)
    del params
    r_err, r_scale, r_same = teacher_forcing_error(
        torch, c32, inputs["params"], batch, tokens)
    torch.cuda.synchronize()
    own_gated = "r_layers" not in inputs["params"]
    log(f"phase 12 {what}: teacher forcing over {S} + {G} tokens in fp32 "
        f"at weights of std 0.02: decode logits vs forward max abs err "
        f"{err:.3g} of max |logit| {scale:.4g} (gate {TF_TOL:g} x), greedy "
        f"ids equal at {same:.4f} of positions; at the run's own weights "
        f"({'gated' if own_gated else 'not gated'}) {r_err:.3g} of "
        f"{r_scale:.4g}, ids equal at {r_same:.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(err <= TF_TOL * scale and math.isfinite(scale),
          f"phase 12 {what}: teacher-forcing logits differ by {err:.3g} "
          f"(max |logit| {scale:.4g})")
    check(not own_gated or (r_err <= TF_TOL * r_scale
                            and math.isfinite(r_scale)),
          f"phase 12 {what}: teacher-forcing logits at the run's weights "
          f"differ by {r_err:.3g} (max |logit| {r_scale:.4g})")


def run_family_path(torch, card, dev):
    """(a)-(f) of phase 12, after flash at its shapes; returns the launch
    counts of its runs, each counted from 0 around its run."""
    import gc
    t_path = time.perf_counter()
    torch.cuda.empty_cache()
    check_flash_families(torch, dev)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()

    add(run_mamba_serve(torch, card, dev))
    add(run_mamba_train(torch, card, dev))
    add(run_hybrid_serve(torch, card, dev))
    add(run_vlm_serve(torch, card, dev))
    add(run_encdec_serve(torch, card, dev))
    add(run_family_train(torch, card, dev))
    log(f"phase 12: {time.perf_counter() - t_path:.1f} s, launches {total}")
    return total


P12_SCHEMES = [("off", {}), ("ecc", {}),
               ("ecc+tmr-parallel", dict(vote_every=8, vote_cache=True))]


def run_mamba_serve(torch, card, dev):
    """(a) mamba2-130m, 24 of 24 layers, batch 4, prompt 2048 (8 SSD
    chunks), gen 32, under the three schemes; then teacher forcing."""
    cfg = p12_config("mamba2-130m")
    reckon(cfg, [s for s, _ in P12_SCHEMES], " (a)", phase="12")
    inputs, clean = p12_inputs(torch, cfg, 4, 2048, dev, "(a)")
    tokens, counts = p12_serve(torch, cfg, inputs, clean, P12_SCHEMES, "(a)")
    check_teacher_forcing(torch, cfg, inputs, tokens, "(a)")
    return counts


def run_mamba_train(torch, card, dev):
    """(b) mamba2-130m by `launch.train` at its defaults (batch 8 x 256,
    fp32), ecc, a scrub every 4 steps at P12_P_BIT, 12 steps."""
    from repro_torch import kernels
    from repro_torch.launch import train

    steps = 12
    args = train_args(dev, "--arch", "mamba2-130m", "--steps", str(steps),
                      "--ecc-scrub-every", "4", "--inject-p-bit",
                      str(P12_P_BIT), "--scheme", "ecc")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    cfg, loop, n_params = train.build(args)
    bits = leaf_bits(loop.state["params"])
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = f"phase 12 (b) train {cfg.name} ecc ({n_params} params)"
    log(f"{what}: {steps} steps in {time.perf_counter() - t0:.1f} s, "
        f"launches {counts}; peak reckoned "
        f"{P10_PEAK_RATIO * p11_copy_bytes(cfg) / 1e9:.2f} GB")
    train_run_stats(torch, loop, args, card, what, peak)
    losses = check_losses(loop, what)
    log(f"{what}: losses {[round(l, 4) for l in losses]}")
    check_scrub_counts(loop, bits, what, P12_P_BIT)
    check(counts.get("encode_parity") == steps + 1
          and counts.get("scrub") == 3, f"{what}: launches {counts}")
    check_descent(torch, cfg, loop, steps - 1, what=what)
    return counts


def run_hybrid_serve(torch, card, dev):
    """(c) recurrentgemma-2b, 26 of 26 layers: batch 4, prompt 256, gen 32
    under the three schemes; then batch 1, prompt 3072 (past the 2048
    window: the windowed flash and the ring cache), gen 32, `off`, and
    teacher forcing."""
    cfg = p12_config("recurrentgemma-2b")
    reckon(cfg, [s for s, _ in P12_SCHEMES], " (c)", phase="12")
    inputs, clean = p12_inputs(torch, cfg, 4, 256, dev, "(c)")
    _, counts = p12_serve(torch, cfg, inputs, clean, P12_SCHEMES, "(c)")
    del inputs, clean
    torch.cuda.empty_cache()
    inputs, clean = p12_inputs(torch, cfg, 1, 3072, dev, "(c) long")
    tokens, long_counts = p12_serve(torch, cfg, inputs, clean,
                                    [("off", {})], "(c) long")
    check_teacher_forcing(torch, cfg, inputs, tokens, "(c) long")
    for k, v in long_counts.items():
        counts[k] = counts.get(k, 0) + v
    return counts


def run_vlm_serve(torch, card, dev):
    """(d) llama-3.2-vision-11b, 1600 image tokens of width 4096, batch 4,
    prompt 256, gen 32: `off` at 40 layers, `ecc` at 20,
    `ecc+tmr-parallel` at 10 (the depths whose reckoned peaks fit)."""
    total = {}
    for spec_s, kw in P12_SCHEMES:
        cfg = p12_config("llama-3.2-vision-11b", P12_VLM_DEPTH[spec_s])
        reckon(cfg, [spec_s], " (d)", phase="12")
        inputs, clean = p12_inputs(torch, cfg, 4, 256, dev, "(d)")
        # one run a depth: a protected run's tokens are held to `serve`'s
        # clean generation of the same config (agreement 1.0)
        _, counts = p12_serve(torch, cfg, inputs, clean, [(spec_s, kw)],
                              "(d)")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del inputs, clean
        torch.cuda.empty_cache()
    return total


def run_encdec_serve(torch, card, dev):
    """(e) seamless-m4t-medium, 12 + 12 layers, batch 4, 256 encoder
    frames of width 1024, prompt 256, gen 32, under the three schemes."""
    cfg = p12_config("seamless-m4t-medium")
    reckon(cfg, [s for s, _ in P12_SCHEMES], " (e)", phase="12")
    inputs, clean = p12_inputs(torch, cfg, 4, 256, dev, "(e)")
    _, counts = p12_serve(torch, cfg, inputs, clean, P12_SCHEMES, "(e)")
    return counts


def check_stack_grads(torch, cfg, loop, what):
    """One backward of step 1's batch at the loop's params through the
    train step's per-layer leaves: every leaf of every stacked key
    finite and nonzero."""
    from repro_torch.core import tree
    from repro_torch.models.steps import _grad_leaves, make_loss_fn
    from repro_torch.models.transformer import STACKED
    params = loop.state["params"]
    grads = tree.map_tree(torch.zeros_like, params)
    total, _ = make_loss_fn(cfg)(_grad_leaves(params, grads),
                                 loop.batch_at(0))
    total.backward()
    stacks = [k for k in STACKED if k in grads]
    bad = [(k,) + p for k in stacks
           for p, g in zip(tree.paths(grads[k]), tree.leaves(grads[k]))
           if not (bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0))]
    n = sum(len(tree.leaves(grads[k])) for k in stacks)
    log(f"{what}: grads of {n} leaves over {stacks} finite and nonzero "
        f"(loss {float(total.detach()):.4f})")
    check(not bad, f"{what}: zero or non-finite grads at {bad[:5]}")
    del grads


def run_family_train(torch, card, dev):
    """(f) three steps of each other family by `launch.train` (batch 8 x
    256, fp32), ecc with a scrub at step 3."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    total = {}
    for arch, depth in P12_TRAIN:
        cfg = get_config(arch)
        cfg = cfg if depth is None else cfg.replace(n_layers=depth)
        args = train_args(dev, "--arch", arch, "--steps", "3",
                          "--ecc-scrub-every", "3", "--inject-p-bit",
                          str(P12_P_BIT), "--scheme", "ecc")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        cfg, loop, n_params = train.build(args, cfg=cfg)
        t0 = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"phase 12 (f) train {cfg.name} at {cfg.n_layers} layers"
        log(f"{what}: 3 steps in {time.perf_counter() - t0:.1f} s, launches "
            f"{counts}; a copy {p11_copy_bytes(cfg) / 1e9:.2f} GB, peak "
            f"reckoned {P10_PEAK_RATIO * p11_copy_bytes(cfg) / 1e9:.2f} GB")
        train_run_stats(torch, loop, args, card, what, peak)
        log(f"{what}: losses "
            f"{[round(l, 4) for l in check_losses(loop, what)]}")
        check_launched(counts, ["encode_parity", "scrub"], what)
        check_stack_grads(torch, cfg, loop, what)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del loop
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    return total


def check_small_reference(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.faults import TransientBitFlips
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.reliability import parse_scheme

    base = get_config("phi3-mini-3.8b").smoke().replace(
        compute_dtype="float32")
    inputs = make_inputs(base, batch=2, prompt_len=32, seed=SEED, device=dev)
    outs = []
    for impl, attn in (("kernel", "pallas"), ("torch", "naive")):
        cfg = base.replace(attention_impl=attn)
        eng = GenerationEngine(cfg, parse_scheme("ecc+tmr-parallel", impl),
                               gen=8, vote_every=2, vote_cache=True,
                               device=dev)
        fault_gen = torch.Generator(device=dev).manual_seed(1)
        store, prep = eng.prepare(inputs["params"], generator=fault_gen,
                                  fault=TransientBitFlips(3e-6))
        tok, tel = eng.generate(store, {"tokens": inputs["tokens"]})
        _, logits, _ = make_prefill_step(cfg)(
            tree.map_tree(lambda x: x[0], store), {"tokens": inputs["tokens"]})
        outs.append((tok, fetch_telemetry({**prep, **tel}), logits))
    (tk, sk, lk), (tp, sp, lp) = outs
    check(torch.equal(tk, tp), "smoke: kernel path tokens != plain path")
    check(sorted(sk) == sorted(sp) and all((sk[k] == sp[k]).all() for k in sk),
          f"smoke: telemetry {sk} != {sp}")
    err = (lk - lp).abs().max().item()
    check(err <= 1e-4, f"smoke: logits differ by {err:.3g}")
    log(f"small reference (phi3 smoke, fp32, ecc+tmr-parallel): kernel path "
        f"== plain path, tokens and counters {sk}; logits max abs err "
        f"{err:.3g}")
    check_small_training(torch, dev)


# ----------------------------------------------------------------------------
# 13. the serving mesh
# ----------------------------------------------------------------------------

#: the mesh phase's model, weight fault rate and decode steps
P13_ARCH = "phi3-mini-3.8b"
P13_P_BIT = 1e-9
P13_GEN = 8
#: (b)'s folded-TMR runs on a 3x1 mesh: (scheme, layers of 32)
P13_FOLD = (("tmr-parallel", 16), ("ecc+tmr-parallel", 16))
#: (c)'s depth, decode steps and one-shot meshes (data, model)
P13_DEPTH = 4
P13_GEN_C = 4
P13_MESHES = ((2, 2), (1, 1))
#: (c)'s runs: `off` and `ecc` in the serving precision (bf16), and `off`
#: in fp32 compute (``@float32``), the reference both are held to
P13_RUNS_C = ("off", "ecc", "off@float32")
P13_REF_C = "off@float32"
#: (c)'s bound on |meshed - unmeshed| first-step logits in fp32, as a
#: share of the unmeshed run's largest |logit| (18 (a)'s): the 2x2 ranks
#: compute their heads and ff slices, whose products the card's GEMMs
#: tile otherwise, and sum the partial products in rank order
P13_LOGIT_REL = 1e-5
#: (c)'s bf16 gate: a 2x2 rank's |bf16 - fp32 unmeshed| first-step logits
#: at most this multiple of the unmeshed bf16 run's own |bf16 - fp32
#: unmeshed|.  In bf16 each rank rounds its partial product before the
#: ordered sum, one rounding more than the whole product has; the fp32
#: runs, within 1e-5, show that the split changes nothing else.  The
#: bound holds the bf16 mesh to the rounding of the same model unmeshed,
#: which the run measures, not to the mesh itself.  The 1x1 rank, whose
#: slice is the whole batch and which splits nothing, is held to the bit
#: in both precisions
P13_BF16_RATIO = 2.0
#: the planted flips of (a): single flips in distinct blocks, two flips in
#: two words of one block, two flips in one word
P13_PLANTS = (4096, 64, 64)
#: 2^28-word chunks of (a)'s seeded arena
P13_CHUNK = 1 << 28
#: the one-shot batch and prompt (phase 4's)
P13_BATCH, P13_PROMPT = 4, 256
#: pass --smoke to the folded serve runs (a CPU rehearsal; never on the card)
P13_SMOKE = False
#: the bytes of a CUDA context, in each rank's reckoning
CUDA_CONTEXT_BYTES = 0.5e9


def p13_config(depth=None):
    from repro_torch.configs import get_config
    cfg = get_config(P13_ARCH)
    return cfg if depth is None else cfg.replace(n_layers=depth)


def rank_ms(torch, dev, fn):
    """(result, ms) of one call: CUDA events on the card, the host clock on
    the CPU (a rehearsal)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    return timed_once(torch, fn)


def seeded_word_chunks(torch, lo: int, hi: int, seed: int, dev,
                       chunk: int = None):
    """(start, end, words) of words [lo, hi) of a random arena whose
    `chunk`-word piece c is drawn from a generator of its own (seed
    1000003 * seed + c), so a rank regenerates its range without the rest
    of the arena (`random_word_chunks` draws the whole arena in order from
    one generator)."""
    chunk = chunk or P13_CHUNK
    for c in range(lo // chunk, (hi - 1) // chunk + 1 if hi > lo else 0):
        g = torch.Generator(device=dev).manual_seed(1000003 * seed + c)
        piece = torch.randint(-2**31, 2**31, (chunk,), dtype=torch.int64,
                              device=dev, generator=g)
        a, b = max(lo, c * chunk), min(hi, (c + 1) * chunk)
        yield a, b, piece[a - c * chunk:b - c * chunk].to(torch.int32)


def fill_words(torch, buf, lo: int, seed: int, chunk: int = None):
    """buf := words [lo, lo + len(buf)) of the seeded arena, in place."""
    for a, b, w in seeded_word_chunks(torch, lo, lo + buf.numel(), seed,
                                      buf.device, chunk):
        buf[a - lo:b - lo] = w


def p13_plants(n_blocks: int, counts=None):
    """The planted flips of (a) as (word index, XOR mask) numpy arrays,
    one entry a word: single flips in distinct blocks, then two words of
    one block, then two bits of one word, in blocks drawn apart."""
    counts = counts or P13_PLANTS
    rs = np.random.RandomState(SEED + 13)
    blocks = np.unique(rs.randint(0, n_blocks, size=2 * sum(counts)))
    blocks = blocks[rs.permutation(blocks.size)][:sum(counts)]
    check(blocks.size == sum(counts), "too few distinct planted blocks")
    masks = {}

    def flip(word, bit):
        masks[int(word)] = masks.get(int(word), 0) ^ (1 << int(bit))

    s, d, _ = counts
    for i, b in enumerate(blocks):
        w = b * 32 + rs.randint(32)
        if i < s:
            flip(w, rs.randint(32))
        elif i < s + d:
            flip(w, rs.randint(32))
            flip(b * 32 + (w - b * 32 + 1 + rs.randint(31)) % 32,
                 rs.randint(32))
        else:
            bit = rs.randint(32)
            flip(w, bit)
            flip(w, (bit + 1 + rs.randint(31)) % 32)
    idx = np.array(sorted(masks), np.int64)
    return idx, np.array([masks[i] for i in idx], np.int64)


def plant(torch, buf, lo: int, plants):
    """XOR the planted flips that fall in words [lo, lo + len(buf)) into
    `buf`, in place."""
    idx, mask = plants
    keep = (idx >= lo) & (idx < lo + buf.numel())
    if keep.any():
        i = torch.as_tensor(idx[keep] - lo, device=buf.device)
        m = torch.as_tensor(mask[keep], device=buf.device)
        buf[i] ^= ((m + 2**31) % 2**32 - 2**31).to(torch.int32)


def digest(words, parity, step: int = 1 << 26) -> tuple:
    """Sums of the words and of their squares and of the parity words and
    of theirs (modulo 2^64, in 2^26-word int64 pieces so no copy of a
    range is made): equal ranges give equal digests."""
    out = []
    for t in (words.view(-1), parity.view(-1)):
        s1 = s2 = 0
        for i in range(0, t.numel(), step):
            c = t[i:i + step].long()
            s1 += int(c.sum())
            s2 += int((c * c).sum())
        out += [s1 % 2**64, s2 % 2**64]
    return tuple(out)


def p13_codes():
    from repro_torch.kernels.diag_parity import encode_parity, scrub
    from repro_torch.kernels.hsiao_secded import encode_hsiao
    from repro_torch.kernels.hsiao_secded import scrub as scrub_h
    return {"diag": (encode_parity, scrub), "hsiao": (encode_hsiao, scrub_h)}


def p13_warm(torch, dev):
    """One launch of each block-code kernel on one block, so no timed
    launch pays for loading its module."""
    from repro_torch.kernels.inject_scrub import inject_scrub
    w = torch.zeros(32, dtype=torch.int32, device=dev)
    for encode, scrub in p13_codes().values():
        scrub(w, encode(w))
    inject_scrub(w, p13_codes()["diag"][0](w), w.clone())
    if dev.type == "cuda":
        torch.cuda.synchronize()


def p13_scrub_whole(torch, dev, n_words: int, shards: int, plants, chunk):
    """(a) in one process: each code's single-launch scrub of the whole
    seeded arena with the planted flips; its counts, its launch time and
    each of `shards` block ranges' digest of fixed words and parity."""
    from repro_torch.kernels.sharded import block_range
    nb = n_words // 32
    p13_warm(torch, dev)
    words = torch.empty(n_words, dtype=torch.int32, device=dev)
    out = {}
    for code, (encode, scrub) in p13_codes().items():
        fill_words(torch, words, 0, SEED, chunk)
        parity = encode(words)
        plant(torch, words, 0, plants)
        (_, par, counts), ms = rank_ms(torch, dev,
                                       lambda: scrub(words, parity))
        ranges = [block_range(nb, shards, k) for k in range(shards)]
        out[code] = {"counts": counts.tolist(), "ms": ms,
                     "digests": [digest(words[lo * 32:hi * 32], par[lo:hi])
                                 for lo, hi in ranges]}
        del parity, par
    del words
    return out


def p13_scrub_rank(dev, n_words: int, plants, pool, chunk: int):
    """(a) on one rank of a 2x2 world: each code's scrub of this rank's
    block range alone -- regenerated, encoded, planted -- by
    `kernels.sharded.scrub_range` (the kernel on the range, the counts
    summed over the world), the ranks launching one after another so each
    launch is timed alone; then `inject_scrub_sharded` over the whole pool
    copy on every rank, and this rank's range of it timed alone."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.inject_scrub import (inject_scrub,
                                                  inject_scrub_sharded)
    from repro_torch.kernels.diag_parity import encode_parity
    from repro_torch.kernels.sharded import block_range, scrub_axes, \
        scrub_range
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(2, 2, device=dev)
    p13_warm(torch, dev)
    kernels.reset_launch_counts()
    axes = scrub_axes(mesh)
    k, n = mesh.index_in(axes), mesh.group_size(axes)
    nb = n_words // 32
    lo, hi = block_range(nb, n, k)
    buf = torch.empty((hi - lo) * 32, dtype=torch.int32, device=dev)
    out = {"range": (lo, hi)}

    def in_turn(fn):
        """fn() on this rank while the others wait: launches timed alone."""
        res = None
        tick = torch.zeros(1, dtype=torch.int32, device=dev)
        for turn in range(n):
            mesh.all_reduce(tick, axes)      # a barrier over the world
            if turn == k:
                res = fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
        mesh.all_reduce(tick, axes)
        return res

    for code, (encode, scrub) in p13_codes().items():
        fill_words(torch, buf, lo * 32, SEED, chunk)
        parity = encode(buf)
        plant(torch, buf, lo * 32, plants)
        ms = {}

        def timed_scrub(b, p, scrub=scrub, ms=ms):
            res, ms["t"] = in_turn(lambda: rank_ms(torch, dev,
                                                   lambda: scrub(b, p)))
            return res

        _, par, counts = scrub_range(timed_scrub, mesh, axes, buf, parity)
        out[code] = {"counts": counts.tolist(), "ms": ms["t"],
                     "digest": digest(buf, par)}
        del parity, par
    del buf
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the pool copy, whole on every rank (0.48 GB at phi3-mini's pool)
    n_pool, pool_plants = pool
    words = torch.empty(n_pool, dtype=torch.int32, device=dev)
    fill_words(torch, words, 0, SEED + 1, chunk)
    parity = encode_parity(words)
    mask = torch.zeros_like(words)
    plant(torch, mask, 0, pool_plants)
    lo, hi = block_range(n_pool // 32, n, k)
    part = [t[lo * 32:hi * 32].clone() for t in (words, mask)] \
        + [parity[lo:hi].clone()]
    fixed, par, counts = inject_scrub_sharded(words, parity, mask, mesh=mesh)
    out["inject"] = {"counts": counts.tolist(),
                     "digest": digest(fixed, par), "range": (lo, hi)}
    _, ms = in_turn(lambda: rank_ms(torch, dev, lambda: inject_scrub(
        part[0], part[2], part[1])))
    out["inject"]["ms"] = ms
    out["launches"] = kernels.launch_counts()
    out["peak"] = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0
    return out


def p13_pool_whole(torch, dev, n_pool: int, pool_plants, chunk: int):
    """(a)'s pool copy in one process: the single-launch inject_scrub."""
    from repro_torch.kernels.diag_parity import encode_parity
    from repro_torch.kernels.inject_scrub import inject_scrub
    words = torch.empty(n_pool, dtype=torch.int32, device=dev)
    fill_words(torch, words, 0, SEED + 1, chunk)
    parity = encode_parity(words)
    mask = torch.zeros_like(words)
    plant(torch, mask, 0, pool_plants)
    p13_warm(torch, dev)
    (fixed, par, counts), ms = rank_ms(
        torch, dev, lambda: inject_scrub(words, parity, mask))
    return {"counts": counts.tolist(), "digest": digest(fixed, par),
            "ms": ms}


def check_sharded_scrubs(torch, dev):
    """(a): the diagonal-parity and Hsiao scrubs over phi3-mini's whole
    arena and inject_scrub over one pool copy, single launch in this
    process against a 2x2 world of gloo ranks on this card."""
    from repro_torch.kernels.sharded import block_range
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    cfg = p13_config()
    n_words = P.layout(T.model_specs(cfg), cfg.param_dtype).n_words
    nb = n_words // 32
    plants = p13_plants(nb)
    n_pool = server_pool_words(cfg)[0]
    pool_nb = n_pool // 32 - (1 if (n_pool // 32) % 4 == 0 else 0)
    pool = (pool_nb * 32, p13_plants(pool_nb, (256, 8, 8)))
    log(f"phase 13 (a): {n_words} arena words ({nb} blocks, "
        f"{plants[0].size} planted words), pool copy {pool_nb} blocks "
        f"(not a multiple of 4); reckoned peaks: one process "
        f"{4 * n_words * (1 + 7 / 32) / 1e9 + 2.1:.1f} GB (the arena, "
        f"the Hsiao table, a 2^28-word int64 chunk), the 2x2 world "
        f"{4 * (n_words / 4 * (1 + 7 / 32) + 3 * n_pool) / 1e9 + 4 * 2.1:.1f}"
        f" GB + 4 contexts")
    torch.cuda.empty_cache()
    whole = p13_scrub_whole(torch, dev, n_words, 4, plants, P13_CHUNK)
    whole["inject"] = p13_pool_whole(torch, dev, *pool, P13_CHUNK)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(p13_scrub_rank, 4, args=(n_words, plants, pool, P13_CHUNK),
                  device=dev.type)
    log(f"phase 13 (a): 2x2 world in {time.perf_counter() - t0:.1f} s")
    rows, launches = {}, {}
    for code, (name, ops_word) in (("diag", ("scrub", 0)),
                                   ("hsiao", ("scrub_hsiao",
                                              HSIAO_SCRUB_OPS_PER_WORD)),
                                   ("inject", ("inject_scrub", 0))):
        w = whole[code]
        for r in ranks:
            got = r[code]
            check(got["counts"] == w["counts"],
                  f"(a) {code}: rank counts {got['counts']} != single "
                  f"launch {w['counts']}")
        if code == "inject":
            check(all(r[code]["digest"] == w["digest"] for r in ranks),
                  "(a) inject_scrub_sharded: the whole pool differs")
        else:
            for k, r in enumerate(ranks):
                check(r[code]["digest"] == w["digests"][k],
                      f"(a) {code}: rank {k}'s range differs")
        check(w["counts"][0] > 0, f"(a) {code}: no corrections")
        f = 7 if code == "hsiao" else 3
        for k, r in enumerate(ranks):
            lo, hi = r["inject"]["range"] if code == "inject" else r["range"]
            words = (hi - lo) * 32
            bytes_ = 4 * words * (2 if code == "inject" else 1) \
                + 4 * (hi - lo) * f
            bound = bound_ms(bytes_, words * ops_word)
            log(f"phase 13 (a) {code} rank {k}: blocks [{lo}, {hi}) "
                f"{r[code]['ms']:.3f} ms, bound {bound[0]:.3f} ms "
                f"({bound[1]})")
        rows[name] = {"whole_ms": w["ms"], "rank_ms": [r[code]["ms"]
                                                      for r in ranks]}
        log(f"phase 13 (a) {code}: counts {w['counts']} equal on every "
            f"rank; single launch {w['ms']:.3f} ms")
    for r in ranks:
        for key, v in r["launches"].items():
            launches[key] = launches.get(key, 0) + v
    log(f"phase 13 (a): rank peaks "
        f"{[round(r['peak'] / 1e9, 2) for r in ranks]} GB, launches "
        f"{launches}")
    return launches, rows


def p13_logits(torch, eng, store, batch):
    """The first generated position's logits (copy 0 under TMR) through
    the engine's own batch split and view, gathered whole."""
    b, rows = eng._split(eng._batch(batch), store)
    prefill, _ = eng._steps(b["tokens"].shape[1])
    with torch.no_grad(), eng._ambient(store, rows):
        params = eng._params(store, 0 if eng.copy_axis else None)
        _, logits, _ = prefill(params, b)
    return eng._join(store, rows, logits.float(), {})[0]


#: the weights' scale where a check holds a mesh's logits to one
#: process's, the cross-checks' (ROADMAP C, "Reference precision"): at the
#: init's "scaled" rule (normal / sqrt of a stacked leaf's layer count)
#: attention amplifies a product's reassociation -- the column slice of a
#: product that the card's GEMM tiles otherwise (`tools/tp_reassociation.
#: py`) -- past any bound a check could hold in fp32
TAME_STD = 0.02


def tame_specs(cfg):
    """`cfg`'s Spec tree with every drawn leaf normal(0, TAME_STD)."""
    from repro_torch.core import tree as T
    from repro_torch.models.params import Spec
    from repro_torch.models.transformer import model_specs
    return T.map_tree(
        lambda s: s if s.init in ("zeros", "ones") else
        Spec(s.shape, s.axes, "normal", TAME_STD, s.dtype), model_specs(cfg))


def p13_knobs() -> dict:
    """What the rank functions take from this module's settings (a
    spawned rank imports the module afresh)."""
    return {"p_bit": P13_P_BIT, "pool_p_bit": POOL_P_BIT,
            "batch": P13_BATCH, "prompt": P13_PROMPT, "spec": server_spec()}


def p13_one_shot(dev, shape, cfg, runs, gen: int, strict: bool, knobs):
    """(c) and (d) on one rank of a `shape` world (or alone, shape None):
    per scheme the serve entry point on the mesh (`serve.serve`, as
    ``serve --mesh`` runs it), its first-step logits, and the transfer
    guard around one more generate + fetch."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.mesh import collectives_issued, make_test_mesh
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.obs import count_host_transfers, fetch_telemetry
    from repro_torch.reliability import parse_scheme
    from repro_torch.models.params import materialize
    mesh = make_test_mesh(*shape, device=dev) if shape else None
    out = {}
    for name in runs:
        # "scheme@dtype": the scheme in that compute dtype
        scheme, _, dtype = name.partition("@")
        run_cfg = cfg.replace(compute_dtype=dtype) if dtype else cfg
        p_bit = knobs["p_bit"] if scheme != "off" else 0.0
        inputs = make_inputs(cfg, knobs["batch"], knobs["prompt"], SEED, dev)
        # every rank and run draws the same weights at TAME_STD: the
        # logits gates hold the 2x2 ranks' split products to one
        # process's
        inputs["params"] = materialize(
            tame_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
            cfg.param_dtype, dev)
        batch = {"tokens": inputs["tokens"]}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = serve(run_cfg, inputs["params"], inputs["tokens"],
                    parse_scheme(scheme), gen=gen, p_bit=p_bit, seed=SEED,
                    device=dev, mesh=mesh)
        launches = kernels.launch_counts()
        eng, store = res["engine"], res["store"]
        logits = p13_logits(torch, eng, store, batch)
        # (d) one more generate from serve's store (warmed up by serve)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() \
            if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        c0 = collectives_issued()
        with count_host_transfers(strict=strict) as timed:
            toks, tel = eng.generate(store, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        collectives = collectives_issued() - c0
        with count_host_transfers(strict=strict) as fetched:
            fetch_telemetry(tel)
        check(torch.equal(toks, res["tokens"]),
              f"(d) {name}: the guarded run's tokens differ")
        out[name] = {
            "tokens": res["tokens"].cpu().numpy(),
            "stats": {k: np.asarray(v) for k, v in res["stats"].items()},
            "logits": logits.cpu().numpy(), "tok_s": res["tok_s"],
            "syncs": (timed.syncs, fetched.syncs, timed.sites),
            "collectives": collectives,
            "launches": launches,
            "peak": max(peak, torch.cuda.max_memory_allocated())
            if dev.type == "cuda" else 0,
            "gen_peak": torch.cuda.max_memory_allocated()
            if dev.type == "cuda" else 0,
            "mesh": "single" if mesh is None else
            res["engine"].exec_mesh.describe()}
        del res, eng, store, inputs, toks, tel
    return out


def check_peaks_within_parity(what, ranks, cfg, n: int,
                              runs=("off", "ecc")) -> None:
    """Every `ecc` rank's generate peak within its parity (3/32 of its
    block range of `cfg`'s arena over n ranks) of the matching `off`
    rank's: the `off` store, dropped, is freed (a store whose arena peers
    had mapped through CUDA IPC stayed allocated on its owner;
    `launch.placement`)."""
    off, ecc = runs
    parity = 4 * 3 * p17_range_words(cfg, n) // 32
    for k, r in enumerate(ranks):
        a, b = r[off]["gen_peak"], r[ecc]["gen_peak"]
        check(abs(b - a) <= parity, f"{what} rank {k}: the {ecc} generate "
              f"peak {b / 1e9:.3f} GB is not within its parity "
              f"{parity / 1e9:.3f} GB of the {off} rank's {a / 1e9:.3f} GB")
    log(f"{what}: {ecc} generate peaks "
        f"{[round(r[ecc]['gen_peak'] / 1e9, 3) for r in ranks]} GB within "
        f"the parity {parity / 1e9:.3f} GB of {off}'s "
        f"{[round(r[off]['gen_peak'] / 1e9, 3) for r in ranks]}")


def p13_server(dev, shape, cfg, n_requests: int, knobs):
    """(c)'s server on one rank of a `shape` world (or alone): phase 5's
    trace under ecc with the pool inject_scrubbed every tick, unpaced (the
    ticks, so the pool's counters, follow the trace alone), then a request
    joining a live ecc batch against the same request alone."""
    import torch
    from repro_torch import kernels
    from repro_torch.faults import TransientBitFlips
    from repro_torch.launch.batching import (ContinuousBatcher, Request,
                                             poisson_trace)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_inputs, serve_server
    from repro_torch.obs import fetch_telemetry
    from repro_torch.reliability import parse_scheme
    mesh = make_test_mesh(*shape, device=dev) if shape else None
    spec = knobs["spec"]
    inputs = make_inputs(cfg, 1, 1, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    pool_fault = TransientBitFlips(knobs["pool_p_bit"])

    def expose(b):
        b.pool.inject_scrub(g, pool_fault)

    kernels.reset_launch_counts()
    res = serve_server(cfg, inputs["params"], parse_scheme("ecc"), spec=spec,
                       requests=n_requests, rate=2.0, p_bit=knobs["p_bit"],
                       seed=SEED, on_tick=expose, realtime=False, device=dev,
                       mesh=mesh)
    out = {"tokens": {r.rid: r.tokens for r in res["results"]},
           "stats": {k: np.asarray(v) for k, v in res["stats"].items()},
           "ticks": res["batcher"].ticks,
           "goodput": res["goodput_tok_s"],
           "launches": kernels.launch_counts()}
    del res
    trace = poisson_trace(5, rate_rps=2.0, spec=spec, vocab=cfg.vocab,
                          seed=SEED)
    live = [Request(i, trace[i].prompt, n)
            for i, n in enumerate((32, 8, 8, 32))]
    live.append(Request(9, trace[4].prompt, 16, arrival_s=0.1))
    joined = []
    for reqs in (live, [Request(9, trace[4].prompt, 16)]):
        b = ContinuousBatcher(cfg, parse_scheme("ecc"), spec, device=dev,
                              mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED + 100)
        prep = b.prepare(inputs["params"], generator=gen,
                         fault=TransientBitFlips(knobs["p_bit"]))
        r9 = {r.rid: r for r in b.run(reqs)}[9]
        stats = fetch_telemetry({**prep, **b.telemetry()})
        stats.pop("tokens_emitted")
        joined.append((r9.tokens, {k: int(v) for k, v in stats.items()}))
        del b, prep
    out["join"] = joined
    out["peak"] = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0
    return out


def add_launches(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def check_same_run(a, b, what, tokens=True):
    """Integer counters exact (and tokens, unless told otherwise)."""
    check(set(a["stats"]) == set(b["stats"]),
          f"{what}: counters {sorted(a['stats'])} != {sorted(b['stats'])}")
    for k in a["stats"]:
        check(np.array_equal(a["stats"][k], b["stats"][k]),
              f"{what}: {k} {a['stats'][k]} != {b['stats'][k]}")
    if tokens:
        check(np.array_equal(a["tokens"], b["tokens"]),
              f"{what}: tokens differ")


def run_folded_tmr(torch, card, dev):
    """(b) ``serve --mesh 3x1`` at phi3-mini's width: each scheme of
    P13_FOLD without a mesh in this process, then on three gloo ranks of
    this card, one TMR copy each; returns the three ranks' launches
    (each rank gated on its own vote and, under ECC, its encode and
    scrub)."""
    from repro_torch.launch import serve as S
    total = {}
    for name, depth in P13_FOLD:
        cfg = p13_config(depth)
        copy = p11_copy_bytes(cfg) / 1e9
        argv = ["--arch", P13_ARCH, "--layers", str(depth), "--batch",
                str(P13_BATCH), "--prompt-len", str(P13_PROMPT), "--gen",
                str(P13_GEN), "--scheme", name, "--inject-p-bit",
                str(P13_P_BIT), "--seed", str(SEED), "--device", dev.type]
        if P13_SMOKE:
            argv.append("--smoke")
        ecc = name.startswith("ecc")
        log(f"phase 13 (b) {name} at {depth} of 32 layers: a copy is "
            f"{copy:.2f} GB; reckoned peaks: alone {(4.11 if ecc else 4.0) * copy:.1f}"
            f" GB (params + three copies{' + parity' if ecc else ''}); 3x1 "
            f"mesh {3 * (4 / 3 + (3 / 32 if ecc else 0)) * copy:.1f} GB "
            f"(each rank: its copy in the params' arena + a third of the "
            f"clean run's store{' + its parity' if ecc else ''}) + 3 "
            f"contexts")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the comparison run: its launches are not the mesh's
        alone = S.main(argv)
        alone_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        ranks = S.main(argv + ["--mesh", "3x1"])
        check(len(ranks) == 3, "(b): three ranks")
        want = ("tmr_vote",) + (("encode_parity", "scrub") if ecc else ())
        for k, r in enumerate(ranks):
            check_same_run(r, alone, f"(b) {name} rank {k}")
            # each copy group votes its own copy's tokens with the others'
            check_launched(r["launches"], want, f"(b) {name} rank {k}")
            add_launches(total, r["launches"])
        if ecc:
            check(alone["stats"]["ecc_corrected"] > 0,
                  f"(b) {name}: no corrections")
        p15_folded_peaks(name, depth, ranks)
        log(f"phase 13 (b) {name}: 3x1 folded tokens and counters "
            f"{alone['stats']} equal alone's on every rank (agreement with "
            f"the clean run {alone['agreement']:.3f}); tok/s 3x1 "
            f"{ranks[0]['tok_s']:.1f} (copies at once) vs alone "
            f"{alone['tok_s']:.1f} (copies one after another), peak alone "
            f"{alone_peak / 1e9:.2f} GB; rank launches "
            f"{[r['launches'] for r in ranks]}")
    return total


def run_mesh_one_shot(torch, card, dev):
    """(c) and (d): the one-shot serve at P13_DEPTH layers of phi3-mini's
    width with the flash kernel (phase 4's setting), under off and ecc in
    bf16 and off in fp32 (P13_RUNS_C), alone and on each of P13_MESHES;
    the server under ecc alone and on a 2x1 world.  The 2x2 ranks' fp32
    logits are held to one process's within P13_LOGIT_REL, their bf16
    logits to the fp32 run alone within P13_BF16_RATIO times the bf16 run
    alone's own distance.  Returns the meshed ranks' launches (the runs
    alone are the comparison, not the mesh)."""
    from repro_torch.launch.mesh import backend_for, spawn
    t_c = time.perf_counter()
    cfg = p13_config(P13_DEPTH).replace(attention_impl="pallas")
    copy = p11_copy_bytes(cfg) / 1e9
    runs = P13_RUNS_C
    total = {}
    log(f"phase 13 (c) at {P13_DEPTH} layers: a copy is {copy:.2f} GB; "
        f"reckoned peaks alone off {1.05 * copy:.1f} / ecc "
        f"{2.10 * copy:.1f} GB; on a 2x2 mesh each rank holds the "
        f"params, its block range and its slice of every leaf (a quarter "
        f"each): about {1.6 * copy:.1f} GB a rank + its context")
    torch.cuda.empty_cache()
    knobs = p13_knobs()
    alone = p13_one_shot(dev, None, cfg, runs, P13_GEN_C, True, knobs)
    meshed = {}
    for shape in P13_MESHES:
        n = shape[0] * shape[1]
        strict = backend_for(dev, n) == "nccl"
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(p13_one_shot, n, args=(shape, cfg, runs, P13_GEN_C,
                                             strict, knobs), device=dev.type)
        meshed[shape] = ranks
        log(f"phase 13 (c) {shape[0]}x{shape[1]}: {n} ranks "
            f"({backend_for(dev, n)}) in {time.perf_counter() - t0:.1f} s, "
            f"rank peaks {[round(r['off']['peak'] / 1e9, 2) for r in ranks]}"
            f" / {[round(r['ecc']['peak'] / 1e9, 2) for r in ranks]} GB")
        for r in ranks:
            for name in runs:
                add_launches(total, r[name]["launches"])
    ref = alone[P13_REF_C]["logits"]
    for name in runs:
        a = alone[name]
        top2 = np.sort(a["logits"], axis=-1)[..., -2:]
        gap = (top2[..., 1] - top2[..., 0]).reshape(-1)
        if name == P13_REF_C:
            tol = P13_LOGIT_REL * float(np.abs(a["logits"]).max())
            near = tol              # a bound on |meshed - alone|
        else:
            # the bf16 run alone's own rounding, against fp32 alone
            base = float(np.abs(a["logits"] - ref).max())
            tol = P13_BF16_RATIO * base
            near = tol + base
        for shape, ranks in meshed.items():
            for k, r in enumerate(ranks):
                got = r[name]
                what = f"(c) {name} {shape[0]}x{shape[1]} rank {k}"
                check_same_run(got, a, what, tokens=False)
                err = float(np.abs(got["logits"] - a["logits"]).max())
                if shape == (1, 1):
                    gated, bound = err, 0.0
                elif name == P13_REF_C:
                    gated, bound = err, tol
                else:
                    gated, bound = float(np.abs(got["logits"] - ref).max()), tol
                check(gated <= bound, f"{what}: logits differ by "
                      f"{gated:.3g} > {bound:.3g}")
                same = (got["tokens"] == a["tokens"]).all(axis=1)
                clear = gap > 2 * near
                check(same[clear].all(), f"{what}: tokens differ in rows "
                      f"whose top-two gap {gap} is clear of the tolerance")
                if shape[1] == 1:
                    check(np.array_equal(got["tokens"], a["tokens"]),
                          f"{what}: tokens differ at model=1")
                if k == 0:
                    held = (f"logits max abs err {err:.3g} against alone's"
                            if name == P13_REF_C or shape == (1, 1) else
                            f"logits max abs err {gated:.3g} against fp32 "
                            f"alone's ({gated / base:.3f}x the bf16 run "
                            f"alone's {base:.3g}), {err:.3g} against bf16 "
                            f"alone's")
                    log(f"{what}: {held} (bound {bound:.3g}), tokens equal "
                        f"in {int(same.sum())}/{same.size} rows (top-two "
                        f"gaps {np.round(gap, 3).tolist()}), counters "
                        f"{ {q: int(v.sum()) for q, v in got['stats'].items()} }"
                        f", {got['tok_s']:.1f} tok/s ({a['tok_s']:.1f} "
                        f"alone), mesh {got['mesh']}")
    if dev.type == "cuda":
        for shape, ranks in meshed.items():
            check_peaks_within_parity(f"phase 13 (c) {shape[0]}x{shape[1]}",
                                      ranks, cfg, shape[0] * shape[1])
    # (d) the guard: no host read in the timed region, one for the fetch
    issued = {}
    for shape, ranks in [(None, [alone])] + list(meshed.items()):
        for k, r in enumerate(ranks):
            for name in runs:
                timed, fetched, sites = r[name]["syncs"]
                check(timed == 0 and fetched == 1,
                      f"(d) {shape} rank {k} {name}: {timed} host reads in "
                      f"the timed region {sites}, {fetched} for the fetch")
        if shape is not None:
            issued[shape] = {
                name: [r[name]["collectives"] for r in ranks]
                for name in runs}
    nccl = [f"{d}x{m}" for d, m in issued if backend_for(dev, d * m) == "nccl"]
    log(f"phase 13 (d): 0 host reads (Tensor.item/tolist/cpu/numpy) in "
        f"every timed region and 1 for each fetch.  Strict (sync debug mode "
        f"'error') ran alone and on the nccl worlds {nccl} (a card a rank; "
        f"a 1x1 world issues no collective); the gloo worlds (ranks sharing "
        f"a card) counted the reads only, and their all-reduces of CUDA "
        f"tensors stage through host memory, which syncs the stream.  "
        f"Collectives in the timed region by world and rank: "
        f"{ {f'{d}x{m}': v for (d, m), v in issued.items()} }")
    log(f"phase 13 (c) one-shot and (d): {time.perf_counter() - t_c:.1f} s")
    # the server
    n_req = 8
    torch.cuda.empty_cache()
    s_alone = p13_server(dev, None, cfg, n_req, knobs)
    torch.cuda.empty_cache()
    s_ranks = spawn(p13_server, 2, args=((2, 1), cfg, n_req, knobs),
                    device=dev.type)
    for k, r in enumerate(s_ranks):
        add_launches(total, r["launches"])
        what = f"(c) server ecc 2x1 rank {k}"
        check(r["tokens"].keys() == s_alone["tokens"].keys()
              and all(np.array_equal(r["tokens"][q], s_alone["tokens"][q])
                      for q in r["tokens"]), f"{what}: tokens differ")
        check_same_run(r, s_alone, what, tokens=False)
        (jt, js), (at, as_) = r["join"]
        check(np.array_equal(jt, at) and js == as_,
              f"{what}: a request joining a live batch != alone")
        check(np.array_equal(jt, s_alone["join"][1][0]),
              f"{what}: join-live tokens != the unmeshed server's")
    check(int(s_alone["stats"]["ecc_corrected"]) > 0,
          "(c) server: no corrections")
    log(f"phase 13 (c) server ecc 2x1: {n_req} requests' tokens and "
        f"counters { {q: int(v.sum()) for q, v in s_alone['stats'].items()} }"
        f" equal alone's ({s_alone['ticks']} ticks); join-live == alone; "
        f"goodput {s_ranks[0]['goodput']:.2f} vs {s_alone['goodput']:.2f} "
        f"tok/s alone (unpaced); rank peaks "
        f"{[round(r['peak'] / 1e9, 2) for r in s_ranks]} GB")
    return total


def run_mesh_path(torch, card, dev):
    """Phase 13: (a) the sharded scrubs, (b) folded TMR, (c) the 2x2 and
    1x1 meshes with (d) the guard; returns the launch counts of the
    meshed ranks of (a)-(d) (each rank counted from 0 around its run; the
    single-process runs they are compared with are left out) and (a)'s
    per-rank rows."""
    t_path = time.perf_counter()
    total = {}
    launches_a, rows = check_sharded_scrubs(torch, dev)
    add_launches(total, launches_a)
    log(f"phase 13 (a): {time.perf_counter() - t_path:.1f} s")
    t0 = time.perf_counter()
    add_launches(total, run_folded_tmr(torch, card, dev))
    log(f"phase 13 (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_launches(total, run_mesh_one_shot(torch, card, dev))
    log(f"phase 13 (c)-(d): {time.perf_counter() - t0:.1f} s")
    check_launched(total, ("encode_parity", "scrub", "encode_hsiao",
                           "scrub_hsiao", "inject_scrub", "tmr_vote",
                           "flash_attention"), "phase 13")
    log(f"phase 13: {time.perf_counter() - t_path:.1f} s, launches {total}")
    return total, rows


# ----------------------------------------------------------------------------
# phase 14: the training step on a mesh (make_train_step(param_pspecs,
# grad_dtype), the ZeRO-1 moments, the configs' policies and overrides,
# restore_resharded)
# ----------------------------------------------------------------------------

P14_ARCH = "phi3-mini-3.8b"
#: (a)'s depth, of 32 layers: the phase's 120 s on one card hold the
#: 2x2 snapshot's save and its restores (5.1 GB of state at 2 layers;
#: 7.8 GB at 4 took 14.7 s to save, call D)
P14_DEPTH = 2
P14_BATCH, P14_SEQ = 8, 256
P14_STEPS = 2
#: AdamW as the CPU tests run it (tests/test_torch_train_mesh.py): clipping
#: out of reach, lr 1e-2 from the first step
P14_OPT = dict(clip_norm=1e3, lr=1e-2, warmup_steps=0)
P14_B1 = 0.9
#: (b): (arch, depth (None: full; an enc-dec's decoder and encoder
#: alike), the smoke config, its world, its sequence).  seamless at 6 + 6
#: of 12 + 12 layers (2,679 exchanges a step at full depth, 8.7 s a step
#: on four ranks sharing the card, call D); llama4's smoke config at 64
#: tokens (its MoE step takes 2.3 s at 256 in one process, call D)
P14_MAMBA = ("mamba2-130m", None, False, (4, 1), 256)
P14_SEAMLESS = ("seamless-m4t-medium", 6, False, (2, 2), 256)
P14_LLAMA4 = ("llama4-maverick-400b-a17b", None, True, (2, 2), 64)
#: smoke configs everywhere (a CPU rehearsal; never on the card)
P14_SMOKE = False
P14_CKPT = ROOT / "build" / "phase14_ckpt"


def p14_config(arch, depth=None, smoke=False):
    """The arch in fp32 compute (the CPU tests' and phase 10's), cut in
    depth only; MoE capacity out of reach: the one process runs one token
    group where a mesh runs one a rank (ROADMAP C, "MoE token groups")."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if smoke or P14_SMOKE:
        cfg = cfg.smoke()
    if depth is not None and not P14_SMOKE:
        cfg = cfg.replace(n_layers=depth)
        if cfg.enc_layers:
            cfg = cfg.replace(enc_layers=depth)
    cfg = cfg.replace(compute_dtype="float32")
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.moe_experts))
    return cfg


def p14_inputs(torch, cfg, dev, seq=None, seed=SEED):
    """std-0.02 weights (`conditioned_params`) and a batch of
    P14_BATCH x `seq` (default P14_SEQ) token ids (and the stub modality
    input)."""
    params = conditioned_params(torch, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    B, S = P14_BATCH, min(seq or P14_SEQ, P14_SEQ)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                                     device=dev, generator=g)}
    if cfg.family == "encdec":
        batch["enc_emb"] = torch.randn((B, S, cfg.d_model), device=dev,
                                       generator=g)
    if cfg.family == "vlm":
        batch["vis_emb"] = torch.randn((B, cfg.vis_tokens, cfg.vis_dim),
                                       device=dev, generator=g)
    return {"params": params, "batch": batch}


def p14_policy(arch, own):
    from repro_torch.configs import DEFAULT_TRAIN_POLICY, get_train_policy
    return get_train_policy(arch) if own else dict(DEFAULT_TRAIN_POLICY)


def p14_k(policy, shape):
    from repro_torch.launch.specs import microbatches
    from repro_torch.pshard import AbstractMesh
    return microbatches(policy["microbatches"], P14_BATCH,
                        AbstractMesh(shape, ("data", "model")))


def p14_reference(torch, cfg, policy, K, inputs, dev, keep=None,
                  final=False):
    """One process's P14_STEPS steps (no mesh) from `inputs`: metrics,
    CUDA-event ms a step, the peak, and what the ranks compare with: the
    params and `m` after the first step (on `keep`'s devices: {"p1": dev,
    "m1": dev}), and with `final` the last state."""
    from repro_torch.core import tree as T
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    keep = keep or {}
    pdt, odt, gdt = (getattr(torch, policy[k]) for k in
                     ("param_dtype", "opt_dtype", "grad_dtype"))
    params = T.map_tree(lambda x: x.to(device=dev, dtype=pdt, copy=True),
                        inputs["params"])
    zeros = lambda x: torch.zeros(x.shape, dtype=odt, device=dev)
    state = {"params": params, "opt": {
        "m": T.map_tree(zeros, params), "v": T.map_tree(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev)}}
    batch = {k: v.to(dev) for k, v in inputs["batch"].items()}
    step = make_train_step(cfg, AdamWConfig(**P14_OPT), microbatches=K,
                           grad_dtype=gdt)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"metrics": [], "ms": []}
    for s in range(P14_STEPS):
        (state, m), ms = rank_ms(torch, dev, lambda: step(state, batch))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["ms"].append(ms)
        if s == 0:
            out["p1"] = T.map_tree(lambda x: x.to(keep.get("p1", dev),
                                                  copy=True), params)
            out["m1"] = T.map_tree(lambda x: x.to(keep.get("m1", dev),
                                                  copy=True),
                                   state["opt"]["m"])
    out["peak"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    out["final"] = state if final else None
    return out


def p14_reckon(cfg, shape, K, policy, rules, shares_card):
    """Each rank's reckoned peak, bytes: its params, `m`, `v`, the grad
    buffers and (K > 1, not fp32 in place) the accumulator; the largest
    layer and the top-level leaves gathered whole, each with its grads
    (fp32 when the model computes in fp32); the activations (each layer's
    input kept for the recompute, one layer's internals, three logits
    chunks); the exchange's staging halves on a shared card; a CUDA
    context."""
    import torch
    from repro_torch.core import tree as T
    from repro_torch.models.params import partition_specs
    from repro_torch.models.transformer import STACKED, model_specs
    from repro_torch.optim.sharding_rules import opt_spec_tree
    from repro_torch.pshard import AbstractMesh, spec_axes
    mesh = AbstractMesh(shape, ("data", "model"))
    specs = model_specs(cfg)

    def local(tree):
        return sum(math.prod(s.shape) // math.prod(
            [mesh.shape[a] for e in sp for a in spec_axes(e)] or [1])
            for s, sp in zip(T.leaves(specs),
                             T.leaves(partition_specs(tree, mesh, rules))))

    size = lambda name: torch.finfo(getattr(torch, policy[name])).bits // 8
    pb, ob, gb = size("param_dtype"), size("opt_dtype"), size("grad_dtype")
    P, M = local(specs), local(opt_spec_tree(specs))
    in_place = K == 1 or (pb == 4 and gb == 4)
    per_layer, top, largest = {}, 0, 0
    for path, s in zip(T.paths(specs), T.leaves(specs)):
        n = math.prod(s.shape)
        depth = STACKED.get(path[0], 0)
        if depth:
            per_layer[path[0]] = per_layer.get(path[0], 0) + \
                n // math.prod(s.shape[:depth])
            largest = max(largest, n // math.prod(s.shape[:depth]))
        else:
            top += n
            largest = max(largest, n)
    wb = 4 if cfg.compute_dtype == "float32" else pb
    pieces = shape[0] if (P14_BATCH // K) % shape[0] == 0 else 1
    rows = max(1, P14_BATCH // K // pieces)
    width = max(cfg.d_model, 2 * (cfg.moe_dff or cfg.d_ff or cfg.d_model))
    out = {
        "state": P * pb + 2 * M * ob + P * pb + (0 if in_place else P * gb),
        "gathered": 0 if shape == (1, 1) else
        2 * wb * (max(per_layer.values(), default=0) + top),
        "activations": 4 * rows * P14_SEQ * (
            cfg.d_model * (cfg.n_layers + cfg.enc_layers + 2) + 4 * width)
        + 3 * 4 * rows * min(512, P14_SEQ) * cfg.padded_vocab,
        "staging": 2 * 4 * largest if shares_card and
        shape[0] * shape[1] > 1 else 0,
        "context": CUDA_CONTEXT_BYTES}
    out["total"] = sum(out.values())
    return out


def p14_errors(torch, plan, state, ref, bf16):
    """The step-1 gates' figures of this rank's shards against one
    process: the params' largest distance in lr and the largest share of
    a leaf's elements apart (bf16: at all; fp32: by more than 1e-3 lr);
    the grads' (m / (1 - b1)) largest distance over the leaf's largest
    grad, over one bf16 step at it, and the share of elements outside
    rtol 1e-3."""
    from repro_torch.core import tree as T
    lr = P14_OPT["lr"]
    dev = plan.mesh.device
    out = {"p_lr": 0.0, "p_share": 0.0, "g_rel": 0.0, "g_step": 0.0,
           "g_share": 0.0}
    for i, lp in enumerate(plan.leaves):
        got = T.leaves(state["params"])[i].float()
        want = T.leaves(ref["p1"])[i][lp.pslice].to(dev).float()
        d = (got - want).abs()
        out["p_lr"] = max(out["p_lr"], float(d.max()) / lr)
        out["p_share"] = max(out["p_share"], float(
            (d > (0.0 if bf16 else 1e-3 * lr)).float().mean()))
        full = T.leaves(ref["m1"])[i]
        scale = max(float(full.float().abs().max()) / (1 - P14_B1), 1e-30)
        gw = full[lp.mslice].to(dev).float() / (1 - P14_B1)
        gg = T.leaves(state["opt"]["m"])[i].float() / (1 - P14_B1)
        dg = (gg - gw).abs()
        out["g_rel"] = max(out["g_rel"], float(dg.max()) / scale)
        out["g_step"] = max(out["g_step"], float(dg.max()) / 2.0 ** (
            math.floor(math.log2(scale)) - 7))
        out["g_share"] = max(out["g_share"], float(
            (dg > 1e-3 * gw.abs() + 1e-6 * scale).float().mean()))
    return out


def p14_replicas(torch, plan, state):
    """(leaves with replicas, mismatches): every shard that several ranks
    hold compared bit for bit with its other holders' (the plan's exact
    exchange over the axes its spec does not split); collective."""
    from repro_torch.core import tree as T
    from repro_torch.launch.shards import axes_of
    mesh = plan.mesh
    checked, bad = 0, []
    for key, specs in (("params", "pspec"), ("m", "mspec"), ("v", "mspec")):
        tree = state["params"] if key == "params" else state["opt"][key]
        for i, (x, lp) in enumerate(zip(T.leaves(tree), plan.leaves)):
            axes = [a for a in mesh.axis_names
                    if a not in axes_of(getattr(lp, specs))]
            if mesh.group_size(axes) <= 1:
                continue
            checked += 1
            for r, part in plan.exchange.parts(x, axes):
                if not torch.equal(part, x):
                    bad.append((key, i, r))
    return checked, bad


def p14_train(torch, mesh, task):
    """One training run of a phase 14 world's rank: this rank's state
    placed from the one process's initial params, P14_STEPS sharded steps
    timed, the step-1 figures (`p14_errors`), the last state against the
    one process's bit for bit where given, the replicas, the elements
    held and the peak.  Returns (figures, state, plan)."""
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import collectives_issued
    from repro_torch.launch.shards import plan_for
    from repro_torch.launch.specs import train_state
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.pshard import DEFAULT_RULES, use_mesh_and_rules
    dev = mesh.device
    cfg, policy, ref = task["cfg"], task["policy"], task["ref"]
    rules = DEFAULT_RULES.replace(**task["overrides"])
    bf16 = policy["param_dtype"] == "bfloat16"
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    plan = plan_for(cfg, mesh, rules)
    # what the rank still holds from its earlier tasks (a kept state, the
    # exchange's staging halves)
    out = {"metrics": [], "ms": [], "base": torch.cuda.memory_allocated(dev)
           if dev.type == "cuda" else 0}
    with use_mesh_and_rules(mesh, rules):
        state = train_state(ref["init"], cfg, mesh, rules, policy, dev)
        step = make_train_step(cfg, AdamWConfig(**P14_OPT),
                               microbatches=task["K"],
                               param_pspecs=plan.pspecs,
                               grad_dtype=getattr(torch,
                                                  policy["grad_dtype"]))
        batch = {k: v.to(dev) for k, v in ref["batch"].items()}
        c0 = collectives_issued()
        for s in range(P14_STEPS):
            if s == 0 and task.get("dry"):
                # phase 15 (c)/(e): this step measured beside its dry run
                (state, m), ms, real = p15_measured_step(torch, plan, step,
                                                         state, batch)
            else:
                (state, m), ms = rank_ms(torch, dev,
                                         lambda: step(state, batch))
            out["ms"].append(ms)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if s == 0:
                out["errors"] = p14_errors(torch, plan, state, ref, bf16)
        out["collectives"] = (collectives_issued() - c0) / P14_STEPS
    if task.get("dry"):
        out["dry"] = {"real": real, "dry": p15_dry_rank(
            mesh, cfg, policy, rules, task["K"], batch)}
    if ref.get("final") is not None:
        fin = ref["final"]
        out["exact"] = all(
            torch.equal(x, T.leaves(w)[i][sl].to(dev))
            for key, w, sls in (
                ("params", fin["params"], "pslice"),
                ("m", fin["opt"]["m"], "mslice"),
                ("v", fin["opt"]["v"], "mslice"))
            for i, (x, sl) in enumerate(zip(
                T.leaves(state["params"] if key == "params"
                         else state["opt"][key]),
                [getattr(lp, sls) for lp in plan.leaves])))
    out["replicas"] = p14_replicas(torch, plan, state)
    out["count"] = int(state["opt"]["count"])
    out["held"] = plan.held()
    out["peak"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if task.get("dry"):
        out["peak"] = max(out["peak"], real["max_before"])
    return out, state, plan


def p14_restore(torch, mesh, task):
    """(c) on a rank: the 2x2 snapshot restored onto this world's mesh,
    every shard against the one process's restore; with a continuation,
    one more step against the one process's, bit for bit."""
    from repro_torch.checkpoint import Checkpointer, restore_resharded
    from repro_torch.core import tree as T
    from repro_torch.launch.shards import plan_for, state_shardings
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.pshard import DEFAULT_RULES, use_mesh_and_rules
    dev = mesh.device
    cfg, ref = task["cfg"], task["ref"]
    plan = plan_for(cfg, mesh, DEFAULT_RULES)
    t0 = time.perf_counter()
    got = restore_resharded(Checkpointer(task["dir"]), state_shardings(plan),
                            mesh=mesh)
    out = {"restore_s": time.perf_counter() - t0}

    def same(state, whole):
        ok = int(state["opt"]["count"]) == int(whole["opt"]["count"])
        for key, sls in (("params", "pslice"), ("m", "mslice"),
                         ("v", "mslice")):
            mine = state["params"] if key == "params" else state["opt"][key]
            want = whole["params"] if key == "params" else whole["opt"][key]
            for x, w, lp in zip(T.leaves(mine), T.leaves(want), plan.leaves):
                ok = ok and torch.equal(x, w[getattr(lp, sls)].to(dev))
        return ok

    out["equal"] = same(got, ref["restored"])
    if ref.get("next") is not None:
        with use_mesh_and_rules(mesh, DEFAULT_RULES):
            step = make_train_step(cfg, AdamWConfig(**P14_OPT),
                                   microbatches=task["K"],
                                   param_pspecs=plan.pspecs)
            got, m = step(got, {k: v.to(dev)
                                for k, v in ref["batch"].items()})
        out["next_metrics"] = {k: float(v) for k, v in m.items()}
        out["next_equal"] = same(got, ref["next"])
    return out


def p14_digest(torch, x) -> int:
    """A digest of a tensor's bits: the wrapping int64 sum of every 32-bit
    (16-bit) word times a weight of its position."""
    w = x.detach().contiguous().reshape(-1)
    w = w.view(torch.int16 if w.element_size() == 2 else torch.int32).long()
    total = 0
    for a in range(0, w.numel(), 1 << 24):
        c = w[a:a + (1 << 24)]
        idx = torch.arange(a, a + c.numel(), dtype=torch.int64,
                           device=c.device)
        total += int((c * ((idx * 2654435761) % 4294967291)).sum())
    return total


def p14_resharded(torch, mesh, task, saved, splan):
    """(c) in the world that saved: the snapshot restored onto another
    mesh of the same ranks, each shard against the saved state's global
    leaves (gathered a leaf at a time from the saving mesh); rank 0 also
    returns each global leaf's digest for the one process's restore."""
    from repro_torch.checkpoint import Checkpointer, restore_resharded
    from repro_torch.core import tree as T
    from repro_torch.launch.shards import assemble, plan_for, state_shardings
    from repro_torch.pshard import DEFAULT_RULES
    plan = plan_for(task["cfg"], mesh, DEFAULT_RULES)
    t0 = time.perf_counter()
    got = restore_resharded(Checkpointer(task["dir"]), state_shardings(plan),
                            mesh=mesh)
    out = {"restore_s": time.perf_counter() - t0, "digests": []}
    equal = int(got["opt"]["count"]) == int(saved["opt"]["count"])
    for key, spec, sl in (("params", "pspec", "pslice"),
                          ("m", "mspec", "mslice"), ("v", "mspec", "mslice")):
        mine = got["params"] if key == "params" else got["opt"][key]
        theirs = saved["params"] if key == "params" else saved["opt"][key]
        for x, y, lp, slp in zip(T.leaves(mine), T.leaves(theirs),
                                 plan.leaves, splan.leaves):
            full = assemble(y, slp.shape, getattr(slp, spec), splan.mesh)
            equal = equal and torch.equal(x, full[getattr(lp, sl)])
            if mesh.rank == 0:
                out["digests"].append(p14_digest(torch, full))
            del full
    out["equal"] = equal
    return out


def p14_rank(dev, shape, tasks):
    """One rank of a phase 14 world: its tasks in order (train runs, the
    save of the kept run's state, a second mesh over the same ranks, the
    snapshot restored onto it or onto this world); returns their
    figures."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shards import state_shardings
    mesh = make_test_mesh(*shape, device=dev)
    out, kept = {"rank": mesh.rank}, None
    for task in tasks:
        t0 = time.perf_counter()
        if task["kind"] == "mesh":
            mesh = make_test_mesh(*task["shape"], device=dev)
        elif task["kind"] == "train":
            fig, state, plan = p14_train(torch, mesh, task)
            fig["task_s"] = time.perf_counter() - t0
            out[task["name"]] = fig
            if task.get("keep"):
                kept = (state, plan)
            del state
        elif task["kind"] == "save":
            ck = Checkpointer(task["dir"], keep=1, async_save=False)
            ck.save(P14_STEPS, kept[0], shardings=state_shardings(kept[1]),
                    mesh=mesh)
            out["save"] = {"save_s": time.perf_counter() - t0}
        elif task["kind"] == "resharded":
            out[task["name"]] = p14_resharded(torch, mesh, task, *kept)
            kept = None
        else:
            out[task["name"]] = p14_restore(torch, mesh, task)
    return out


def p14_task(name, cfg, policy, overrides, K, ref, inputs, **kw):
    return dict(kind="train", name=name, cfg=cfg, policy=policy,
                overrides=overrides, K=K,
                ref={"init": inputs["params"], "batch": inputs["batch"],
                     "p1": ref["p1"], "m1": ref["m1"],
                     "final": ref["final"]}, **kw)


def p14_gate(what, got, ref, bf16, exact=False):
    """(a)-(b)'s gates on one rank's figures against the one process."""
    check(got["count"] == P14_STEPS, f"{what}: count {got['count']}")
    checked, bad = got["replicas"]
    check(not bad, f"{what}: replicated shards differ {bad[:4]}")
    for s, (a, b) in enumerate(zip(got["metrics"], ref["metrics"])):
        if exact:
            check(a == b, f"{what}: step {s} metrics {a} != one process's "
                  f"{b}")
            continue
        # the first loss is the same params' on the same batch; after a
        # step of lr 1e-2 from std-0.02 weights the elements whose
        # near-zero grads took the other sign sit 2 lr apart (at most 0.1%
        # of a leaf's, the step-1 gate), which moves the next loss by
        # 1.6e-5 at phi3-mini's width (call A): later losses at 1e-4
        # (bf16 params: 1e-3, as in the CPU tests)
        tol = (1e-3 if bf16 else 1e-4) if s else 1e-5
        check(abs(a["loss"] - b["loss"]) <= tol * abs(b["loss"]),
              f"{what}: step {s} loss {a['loss']} vs {b['loss']}")
    if exact:
        check(got["exact"], f"{what}: the last params, m or v differ from "
              f"one process's")
        e = got["errors"]
        check(e["p_lr"] == 0 and e["g_rel"] == 0,
              f"{what}: the first step differs from one process's {e}")
        return
    e = got["errors"]
    check(e["p_lr"] <= 2.5, f"{what}: a param {e['p_lr']:.3g} lr apart")
    if bf16:
        # bf16 params and moments: a grad one bf16 step apart moves its
        # param's update by about 2^-8 lr, which flips the param's rounding
        # about a third of the time; the reference and the port's
        # one-device step differ in 0.23-0.98% of the params after one step
        # at the smoke shapes (CPU), so the params are held at 1%
        check(e["p_share"] <= 1e-2 and e["g_step"] <= 1.0
              and e["g_share"] <= 1e-2, f"{what}: bf16 step 1 {e}")
    else:
        check(e["p_share"] <= 1e-3 and e["g_rel"] <= 1e-5,
              f"{what}: fp32 step 1 {e}")


def p14_line(what, ranks, name, ref, reckon):
    """A run's figures: losses, step ms beside one process's, rank peaks
    beside the reckoning, the collectives a step, the step-1 figures."""
    r0 = ranks[0][name]
    peaks = [r[name]["peak"] / 1e9 for r in ranks]
    base = [r[name]["base"] / 1e9 for r in ranks]
    log(f"{what}: losses {[round(m['loss'], 6) for m in r0['metrics']]} "
        f"(one process {[round(m['loss'], 6) for m in ref['metrics']]}), "
        f"grad norms {[round(m['grad_norm'], 5) for m in r0['metrics']]}; "
        f"step ms {[round(x, 1) for x in r0['ms']]} (one process "
        f"{[round(x, 1) for x in ref['ms']]}); rank peaks "
        f"{[round(p, 2) for p in peaks]} GB, {sum(peaks):.2f} summed, of "
        f"which held from earlier tasks {[round(b, 2) for b in base]} "
        f"(reckoned for the run {reckon['total'] / 1e9:.2f} a rank: "
        + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in reckon.items()
                    if k != "total")
        + f"; one process {ref['peak'] / 1e9:.2f}); held "
        f"{r0['held']} elements; collectives a step "
        f"{[r[name]['collectives'] for r in ranks]}; the run "
        f"{r0['task_s']:.1f} s on rank 0; replicated leaves "
        f"{r0['replicas'][0]}, bit-identical; step 1 {r0['errors']}")


def p14_rows_k(K, shape):
    """The one process's micro-slices for a world's run at K: as many as
    make each slice the rows a rank holds of one (K times the batch
    pieces).  cuBLAS picks its kernels by the batch shape, so a rank's
    one-row products round otherwise than a four-row product, and depth
    amplifies that (mamba2-130m's 24 layers: 7.9e-5 of a leaf's largest
    grad against one process at the same K, call C; 6.9e-7 on the CPU,
    whose products round alike); one process at the ranks' rows makes
    their products, and leaves what the mesh adds: the exchanges, the
    sums over the ranks, the sharded update."""
    pieces = shape[0] if (P14_BATCH // K) % shape[0] == 0 else 1
    return K * pieces


def run_train_mesh_path(torch, card, dev):
    """Phase 14 on one card, two worlds.  Four gloo ranks sharing the
    card: (a) phi3-mini at P14_DEPTH layers on 2x2, its state saved, (b)
    seamless-m4t-medium and llama4's smoke config (bf16 policy) on 2x2,
    then a 4x1 mesh over the same ranks: (a) there, (b) mamba2-130m, (c)
    the 2x2 snapshot restored onto 4x1.  One nccl rank: (a) on 1x1 bit
    for bit, (c) the snapshot restored and one more step against one
    process's.  Each run is held against one process (`p14_rows_k`; the
    bf16 one at the same K, and that one process against the CPU), the
    one process's restore against the saved leaves' digests.  Returns {}
    (the training step launches none of the kernels)."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_rules_overrides
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import backend_for, spawn
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.pshard import DEFAULT_RULES
    t_path = time.perf_counter()
    shutil.rmtree(P14_CKPT, ignore_errors=True)
    ckpt = str(P14_CKPT)
    policy = p14_policy(P14_ARCH, False)
    cfg = p14_config(P14_ARCH, P14_DEPTH)
    inputs = p14_inputs(torch, cfg, dev)
    n_params = sum(x.numel() for x in T.leaves(inputs["params"]))
    log(f"phase 14 (a): {cfg.name} at {cfg.n_layers} of 32 layers, "
        f"{n_params} params, fp32 compute, batch {P14_BATCH} x {P14_SEQ}, "
        f"{P14_STEPS} steps; AdamW {P14_OPT}")
    shares = lambda shape: backend_for(dev, shape[0] * shape[1]) == "gloo"
    Ks = {shape: p14_k(policy, shape) for shape in ((2, 2), (4, 1), (1, 1))}
    K1 = Ks[(1, 1)]
    check(all(p14_rows_k(k, s) == K1 for s, k in Ks.items()),
          f"(a): every world's rows a slice are the 1x1 world's {Ks}")
    # one process at the ranks' rows (K1), its last state kept for 1x1
    ref_a = p14_reference(torch, cfg, policy, K1, inputs, dev, final=True)

    def world(shape, tasks):
        n = shape[0] * shape[1]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(p14_rank, n, args=(shape, tasks), device=dev.type)
        log(f"phase 14: the {shape[0]}x{shape[1]} world's {n} rank(s) "
            f"({backend_for(dev, n)}) in {time.perf_counter() - t0:.1f} s")
        return ranks

    def gate_all(what, ranks, name, ref, bf16=False, exact=False):
        for k, r in enumerate(ranks):
            p14_gate(f"{what} rank {k}", r[name], ref, bf16, exact)

    def a_task(name, shape, **kw):
        return p14_task(name, cfg, policy, {}, Ks[shape], dict(
            ref_a, final=ref_a["final"] if shape == (1, 1) else None),
            inputs, **kw)

    def run_b(spec, shape):
        arch, depth, smoke, _, seq = spec
        c = p14_config(arch, depth, smoke)
        inp = p14_inputs(torch, c, dev, seq)
        own = arch != P14_SEAMLESS[0]        # seamless has no train policy
        pol = p14_policy(arch, own)
        K = p14_k(pol, shape)
        bf16 = pol["param_dtype"] == "bfloat16"
        ref = p14_reference(torch, c, pol, K if bf16 else
                            p14_rows_k(K, shape), inp, dev)
        return c, inp, pol, K, ref

    # -- four ranks: 2x2, then 4x1 over the same ranks -----------------------
    cfg_s, in_s, pol_s, K_s, ref_s = run_b(P14_SEAMLESS, (2, 2))
    cfg_l, in_l, pol_l, K_l, ref_l = run_b(P14_LLAMA4, (2, 2))
    ref_lc = p14_reference(torch, cfg_l, pol_l, K_l, in_l,
                           torch.device("cpu"))
    cfg_m, in_m, pol_m, K_m, ref_m = run_b(P14_MAMBA, (4, 1))
    over = {a: get_rules_overrides(a) for a in
            (P14_SEAMLESS[0], P14_LLAMA4[0], P14_MAMBA[0])}
    tasks = [a_task("a", (2, 2), keep=True, dry=True),
             {"kind": "save", "dir": ckpt},
             p14_task("seamless", cfg_s, pol_s, over[P14_SEAMLESS[0]], K_s,
                      ref_s, in_s),
             p14_task("llama4", cfg_l, pol_l, over[P14_LLAMA4[0]], K_l,
                      ref_l, in_l),
             {"kind": "mesh", "shape": (4, 1)},
             a_task("a41", (4, 1)),
             p14_task("mamba", cfg_m, pol_m, over[P14_MAMBA[0]], K_m, ref_m,
                      in_m),
             {"kind": "resharded", "name": "resharded", "cfg": cfg,
              "dir": ckpt}]
    ranks = world((2, 2), tasks)
    lines = [("a", f"(a) 2x2 K={Ks[(2, 2)]}", ref_a, cfg, (2, 2),
              Ks[(2, 2)], policy, {}),
             ("seamless", f"(b) {cfg_s.name} at {cfg_s.enc_layers} + "
              f"{cfg_s.n_layers} layers, 2x2 K={K_s} (its overrides)",
              ref_s, cfg_s, (2, 2), K_s, pol_s, over[P14_SEAMLESS[0]]),
             ("llama4", f"(b) {cfg_l.name} smoke, 2x2 K={K_l} (bf16 policy "
              f"{pol_l}; one process on the CPU: losses "
              f"{[round(m['loss'], 6) for m in ref_lc['metrics']]})", ref_l,
              cfg_l, (2, 2), K_l, pol_l, over[P14_LLAMA4[0]]),
             ("a41", f"(a) 4x1 K={Ks[(4, 1)]}", ref_a, cfg, (4, 1),
              Ks[(4, 1)], policy, {}),
             ("mamba", f"(b) {cfg_m.name} 4x1 K={K_m} (its overrides: "
              f"params replicated, ZeRO-1 moments a quarter each)", ref_m,
              cfg_m, (4, 1), K_m, pol_m, over[P14_MAMBA[0]])]
    for name, what, ref, c, shape, K, pol, ov in lines:
        if pol["param_dtype"] != "bfloat16":
            what += f" against one process at K={p14_rows_k(K, shape)}"
        p14_line("phase 14 " + what, ranks, name, ref, p14_reckon(
            c, shape, K, pol, DEFAULT_RULES.replace(**ov), shares(shape)))
    r0 = ranks[0]
    log(f"phase 14 (c): the 2x2 state after step {P14_STEPS} saved in "
        f"{r0['save']['save_s']:.1f} s (rank 0 writes the global leaves one "
        f"at a time), restored onto 4x1 in "
        f"{[round(r['resharded']['restore_s'], 1) for r in ranks]} s")
    for s_, (a, b) in enumerate(zip(ref_l["metrics"], ref_lc["metrics"])):
        tol = 1e-3 if s_ else 1e-5
        check(abs(a["loss"] - b["loss"]) <= tol * abs(b["loss"]),
              f"(b) llama4 one process: card loss {a['loss']} vs CPU "
              f"{b['loss']} at step {s_}")
    for name, what, ref, _, _, _, pol, _ in lines:
        gate_all(what, ranks, name, ref, pol["param_dtype"] == "bfloat16")
    p15_gate_world("phase 15 (c) inside phase 14 (a)'s 2x2 world", ranks, "a")
    for k, r in enumerate(ranks):
        h = r["mamba"]["held"]
        check(4 * h["m"] == 4 * h["v"] == h["params"],
              f"(b) mamba2 4x1 rank {k}: m and v are not a quarter of the "
              f"params {h}")
        check(r["resharded"]["equal"], f"(c) 4x1 rank {k}: restored shards "
              f"!= the saved leaves' slices")
    digests = r0["resharded"]["digests"]
    del ref_s, ref_l, ref_lc, ref_m, in_s, in_l, in_m, ranks

    # -- one process's restore and its next step --------------------------
    t0 = time.perf_counter()
    restored = Checkpointer(ckpt).restore_tensors(device=dev)
    load_s = time.perf_counter() - t0
    mine = [p14_digest(torch, x) for key in ("params", "m", "v")
            for x in T.leaves(restored["params"] if key == "params"
                              else restored["opt"][key])]
    check(mine == digests, "(c) one process: the restored leaves' digests "
          "!= the saved leaves'")
    nxt = T.map_tree(lambda x: x.clone(), restored)
    nxt, m = make_train_step(cfg, AdamWConfig(**P14_OPT), microbatches=K1)(
        nxt, {k: v for k, v in inputs["batch"].items()})
    next_m = {k: float(v) for k, v in m.items()}
    log(f"phase 14 (c): one process restored the snapshot in {load_s:.1f} s"
        f", its {len(mine)} leaves' digests equal the saved leaves'; its "
        f"next step (K={K1}): loss {next_m['loss']:.6f}")

    # -- one nccl rank: (a) to the bit, the restore and its next step ------
    shape = (1, 1)
    tasks = [a_task("a", shape),
             dict(kind="restore", name="restore", cfg=cfg, dir=ckpt, K=K1,
                  ref={"restored": restored, "next": nxt,
                       "batch": inputs["batch"]})]
    ranks = world(shape, tasks)
    p14_line(f"phase 14 (a) 1x1 K={K1}", ranks, "a", ref_a, p14_reckon(
        cfg, shape, K1, policy, DEFAULT_RULES, False))
    r = ranks[0]["restore"]
    log(f"phase 14 (c): restored onto 1x1 in {r['restore_s']:.1f} s; its "
        f"next step: loss {r['next_metrics']['loss']:.6f}, grad norm "
        f"{r['next_metrics']['grad_norm']:.6f} (one process "
        f"{next_m['loss']:.6f}, {next_m['grad_norm']:.6f})")
    gate_all("(a) 1x1", ranks, "a", ref_a, exact=True)
    check(r["equal"], "(c) 1x1: restored shards != the saved leaves")
    check(r["next_equal"] and r["next_metrics"] == next_m,
          f"(c) 1x1: the next step {r['next_metrics']} != one process's "
          f"{next_m}")
    del ref_a, restored, nxt, ranks, inputs
    shutil.rmtree(P14_CKPT, ignore_errors=True)
    log(f"phase 14: {time.perf_counter() - t_path:.1f} s")
    return {}


def run_train_mesh_four(torch, card, dev):
    """Phase 14 (d), four cards (`tools/chip_phase.py 14d`): phi3-mini at
    full width and depth on 2x2 over nccl, a card a rank, K = 1, against
    one process on one card (phase 10 (a)'s shape without the arena).  The
    one process's initial params, first params and first `m` are kept on
    cards 1-3, so card 0 holds its rank alone during the world."""
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import backend_for, spawn
    from repro_torch.pshard import DEFAULT_RULES
    check(torch.cuda.device_count() >= 4, "phase 14 (d) needs four cards")
    t_path = time.perf_counter()
    policy = p14_policy(P14_ARCH, False)
    cfg = p14_config(P14_ARCH)
    shape, K = (2, 2), 1
    inputs = p14_inputs(torch, cfg, dev)
    inputs["params"] = T.map_tree(lambda x: x.to("cuda:1"),
                                  inputs["params"])
    torch.cuda.empty_cache()
    ref = p14_reference(torch, cfg, policy, p14_rows_k(K, shape), inputs,
                        dev, keep={"p1": torch.device("cuda:2"),
                                   "m1": torch.device("cuda:3")})
    torch.cuda.empty_cache()
    n = sum(x.numel() for x in T.leaves(inputs["params"]))
    reckon = p14_reckon(cfg, shape, K, policy, DEFAULT_RULES, False)
    log(f"phase 14 (d): {cfg.name} at full depth ({n} params), 2x2 over "
        f"{backend_for(dev, 4)}, K={K} (one process K="
        f"{p14_rows_k(K, shape)}); reckoned {reckon['total'] / 1e9:.2f}"
        f" GB a rank ({n * 16 / 4 / 1e9:.2f} of state)")
    t0 = time.perf_counter()
    ranks = spawn(p14_rank, 4, args=(shape, [p14_task(
        "a", cfg, policy, {}, K, ref, inputs, dry=True)]), device=dev.type)
    log(f"phase 14 (d): 4 ranks in {time.perf_counter() - t0:.1f} s")
    p14_line("phase 14 (d) 2x2 nccl, a card a rank", ranks, "a", ref, reckon)
    for k, r in enumerate(ranks):
        p14_gate(f"(d) 2x2 rank {k}", r["a"], ref, False)
    p15_gate_world("phase 15 (e) inside phase 14 (d)'s four-card world",
                   ranks, "a")
    log(f"phase 14 (d): {time.perf_counter() - t_path:.1f} s")
    return {}


# -- phase 15: the dry run held against the card --------------------------------

#: (a)'s depth of 32 layers (phase 10 (a)'s, the one process's step)
P15_DEPTH = 16
#: (b)'s serving shape: phase 4's one-shot prefill, then one decode step
P15_BATCH, P15_PROMPT = 4, 256
#: a dry run's peak against the card's (`max_memory_allocated` after
#: `reset_peak_memory_stats`, less what the process holds besides the
#: step's inputs)
P15_PEAK_TOL = 0.10
#: smoke configs (a CPU rehearsal; never on the card)
P15_SMOKE = False


def p15_config(depth=None, compute_dtype=None):
    from repro_torch.configs import get_config
    cfg = get_config(P14_ARCH)
    if P15_SMOKE:
        cfg = cfg.smoke()
    elif depth is not None:
        cfg = cfg.replace(n_layers=depth)
    return cfg.replace(compute_dtype=compute_dtype) if compute_dtype else cfg


def p15_measure(torch, dev, fn, args):
    """(fn's result, figures) of one call: its FLOPs (`FlopCounterMode`),
    CUDA-event ms, `args`' bytes (`dryrun.storage_bytes`) and its peak:
    `max_memory_allocated` after `reset_peak_memory_stats`, less what the
    process holds besides `args` when the call starts (0 off the card)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import storage_bytes
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    arg = storage_bytes(args)
    besides = torch.cuda.memory_allocated() - arg if cuda else 0
    with FlopCounterMode(display=False) as fc:
        out, ms = rank_ms(torch, dev, fn)
    peak = torch.cuda.max_memory_allocated() - besides if cuda else 0
    return out, {"flops": fc.get_total_flops(), "arg_bytes": arg,
                 "besides": besides, "peak": peak, "ms": ms}


def p15_gate(what, dry, real, exchanges=None, args=True):
    """FLOPs exact, and argument bytes (unless not `args`) and the
    exchanges (where given), the peak within P15_PEAK_TOL of the card's
    (on the card)."""
    check(dry["flops"] == real["flops"], f"{what}: the dry run's FLOPs "
          f"{dry['flops']:.6g} != the card's {real['flops']:.6g}")
    check(not args or dry["arg_bytes"] == real["arg_bytes"],
          f"{what}: the dry run's arg_bytes {dry['arg_bytes']} != the "
          f"card's {real['arg_bytes']}")
    if exchanges is not None:
        n = sum(dry["collectives"]["per_op_count"].values())
        check(n == exchanges, f"{what}: the dry run records {n} exchanges, "
              f"the rank made {exchanges}")
    if real["peak"]:
        err = dry["peak_bytes"] / real["peak"] - 1
        check(abs(err) <= P15_PEAK_TOL, f"{what}: the dry run's peak "
              f"{dry['peak_bytes'] / 1e9:.3f} GB is {100 * err:+.1f}% of "
              f"the card's {real['peak'] / 1e9:.3f} GB")


def p15_line(what, dry, real):
    gb = lambda x: f"{x / 1e9:.3f}"
    err = (f"{100 * (dry['peak_bytes'] / real['peak'] - 1):+.1f}%"
           if real["peak"] else "not measured off the card")
    log(f"{what}: dry run peak {gb(dry['peak_bytes'])} GB (args "
        f"{gb(dry['arg_bytes'])}, temp {gb(dry['temp_bytes'])}, out - alias "
        f"{gb(dry['out_bytes'] - dry['alias_bytes'])}), the card's "
        f"{gb(real['peak'])} ({err}; held besides the inputs "
        f"{gb(real['besides'])} subtracted); "
        f"FLOPs {dry['flops']:.6g} (card {real['flops']:.6g}); arg_bytes "
        f"{dry['arg_bytes']} (card {real['arg_bytes']}); bytes accessed "
        f"{dry['bytes_accessed']:.4g}; collectives "
        f"{dry['collectives']['per_op_count']}; meta run {dry['lower_s']} s, "
        f"the card's call {real['ms']:.1f} ms")


def run_dryrun_path(torch, card, dev):
    """Phase 15 (a) and (b) on one card (`tools/chip_phase.py 15`): the
    dry run of one process's steps held against the same steps on the
    card.  (a) phi3-mini's training step at P15_DEPTH layers, fp32, batch
    P14_BATCH x P14_SEQ, K = 1, a leaf a tensor as the dry run lays them
    out; (b) a one-shot prefill at phase 4's shape and one decode step
    after it, bf16 params in one arena at full depth.  Gates: FLOPs and
    argument bytes exact, peaks within P15_PEAK_TOL.  Returns {} (no
    kernel is launched)."""
    from repro_torch.configs import DEFAULT_TRAIN_POLICY
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models.params import materialize
    from repro_torch.models.steps import (make_decode_step,
                                          make_prefill_step,
                                          make_train_step)
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import AdamWConfig, init_opt_state
    t_path = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 15)

    # (a) one process's training step
    cfg = p15_config(P15_DEPTH, "float32")
    B, S = P14_BATCH, P14_SEQ
    thunk, args, _ = D.lower(cfg, ShapeSpec("phase15a", "train", S, B), None,
                             None, dict(DEFAULT_TRAIN_POLICY), K=1)
    dry = D.measure(thunk, args)
    del thunk, args
    arena = materialize(model_specs(cfg), g, "float32", dev)
    params = T.map_tree(lambda x: x.clone(), arena)     # a leaf a tensor
    del arena
    state = {"params": params, "opt": init_opt_state(params)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                                     device=dev, generator=g)}
    step = make_train_step(cfg, AdamWConfig(), microbatches=1)
    _, real = p15_measure(torch, dev, lambda: step(state, batch),
                          (state, batch))
    what = (f"phase 15 (a) {cfg.name} at {cfg.n_layers} layers, fp32, "
            f"train {B} x {S}, K=1")
    p15_line(what, dry, real)
    p15_gate(what, dry, real)
    del state, params, batch, step

    # (b) the serving steps, bf16 params in one arena at full depth
    cfg = p15_config()
    params = materialize(model_specs(cfg), g, cfg.compute_dtype, dev)
    tokens = torch.randint(0, cfg.vocab, (P15_BATCH, P15_PROMPT),
                           dtype=torch.int32, device=dev, generator=g)
    for kind, seq in (("prefill", P15_PROMPT), ("decode", P15_PROMPT + 1)):
        thunk, args, _ = D.lower(cfg, ShapeSpec(f"phase15b_{kind}", kind,
                                                seq, P15_BATCH))
        dry = D.measure(thunk, args)
        del thunk, args
        with torch.no_grad():
            if kind == "prefill":
                fn = make_prefill_step(cfg)
                ins = (params, {"tokens": tokens})
            else:
                # a cache one position longer than the prompt
                tok, _, cache = make_prefill_step(cfg, cache_len=seq)(
                    params, {"tokens": tokens})
                fn = make_decode_step(cfg)
                ins = (params, tok, cache)
            out, real = p15_measure(torch, dev, lambda: fn(*ins), ins)
        what = (f"phase 15 (b) {cfg.name} at {cfg.n_layers} layers, bf16 "
                f"params, {kind} B={P15_BATCH} S={seq}")
        p15_line(what, dry, real)
        # the decode's cache is the prefill's, laid out as the model makes
        # it; the dry run's is a tensor a leaf
        p15_gate(what, dry, real, args=kind == "prefill")
        del out, ins
    del params, tokens
    log(f"phase 15 (a)-(b): {time.perf_counter() - t_path:.1f} s")
    return {}


def p15_measured_step(torch, plan, step, state, batch):
    """A phase 14 rank's first step measured for phase 15 (c) and (e):
    `p15_measure`'s figures, and the exchanges it made: the `Exchange`'s
    posts through staging halves on a shared card, plus every collective
    it issued but the barriers (which order a shared card's staging and
    are no exchange).  On a shared card the staging halves are mapped
    first at the step's largest post (a whole leaf's fp32 grad): a remap
    inside the step would leave the superseded halves allocated until
    CUDA IPC's collector frees them, at a time that varies by rank.  The
    halves, which a card a rank does not hold, are then among what the
    rank holds besides the step's inputs, and out of its peak.  Returns
    ((state, metrics), ms, figures)."""
    from repro_torch.launch.mesh import collective_log
    ex = plan.exchange
    dev = plan.mesh.device
    # the task's peak so far (p15_measure resets it)
    before = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    if ex.peer:
        ex._map(4 * max(math.prod(lp.shape) for lp in plan.leaves))
        torch.cuda.ipc_collect()
    posts = ex._count
    with collective_log() as issued:
        out, real = p15_measure(torch, dev, lambda: step(state, batch),
                                (state, batch))
    real["max_before"] = before
    real["exchanges"] = ex._count - posts + sum(
        op != "barrier" for op, _, _ in issued)
    real["staging"] = 0 if ex._mine is None else ex._mine.numel()
    return out, real["ms"], real


def p15_dry_rank(mesh, cfg, policy, rules, K, batch):
    """This rank's dry run of its own training cell: the same config,
    policy, rules, K and batch shape on a `RecordingMesh` of the world's
    shape at this rank, its gathers read as the world reads them (peers'
    staging on a shared card, `peer_views`)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.optim import AdamWConfig
    B, S = batch["tokens"].shape
    rec = RecordingMesh(mesh.sizes, mesh.axis_names, mesh.rank,
                        peer_views=mesh.shares_card)
    thunk, args, _ = D.lower(cfg, ShapeSpec("phase14", "train", S, B), rec,
                             rules, policy, K, AdamWConfig(**P14_OPT))
    return D.measure(thunk, args, rec.log)


def p15_gate_world(what, ranks, name):
    """(c) and (e): each rank's dry run of its cell against its first
    step: exchanges, FLOPs and argument bytes exact, the peak within
    P15_PEAK_TOL."""
    for k, r in enumerate(ranks):
        fig = r[name]["dry"]
        staging = fig["real"]["staging"]
        p15_line(f"{what}, rank {k} (exchanges {fig['real']['exchanges']}"
                 + (f"; the shared card's staging halves, "
                    f"{staging / 1e9:.3f} GB, among what it holds besides"
                    if staging else "") + ")", fig["dry"], fig["real"])
        p15_gate(f"{what}, rank {k}", fig["dry"], fig["real"],
                 fig["real"]["exchanges"])


def p15_folded_peaks(name, depth, ranks):
    """(d): phase 13 (b)'s ``serve --mesh 3x1`` ranks' peaks beside each
    rank's dry run of the folded engine's generate (its copy, the batch,
    the generate's own buffers).  A rank's peak is its whole run's: under
    ``tmr-parallel`` that is the generate's (the copy lives in the params'
    own arena), gated within P15_PEAK_TOL; an ECC scheme's prepare also
    holds its range's parity twice (the encode and the scrub's copy),
    which the generate does not, so its peaks are printed, not gated.
    The ranks' shards have one shape (a copy each), so rank 0's dry run
    stands for each."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import RecordingMesh
    cfg = get_config(P13_ARCH)
    if P13_SMOKE:
        cfg = cfg.smoke()
    cfg = cfg.replace(n_layers=depth)
    # every rank holds one whole copy: rank 0's dry run is each rank's
    dry = D.engine_cell(cfg, name, RecordingMesh((3, 1), ("data", "model")),
                        batch=P13_BATCH, prompt_len=P13_PROMPT, gen=P13_GEN)
    for k, r in enumerate(ranks):
        peak = r["peak_bytes"]
        err = dry["peak_bytes"] / peak - 1 if peak else 0.0
        log(f"phase 15 (d) {name} 3x1 rank {k}: the dry run of the folded "
            f"engine's generate peak {dry['peak_bytes'] / 1e9:.3f} GB (args "
            f"{dry['arg_bytes'] / 1e9:.3f}, temp {dry['temp_bytes'] / 1e9:.3f}"
            f"), the rank's run {peak / 1e9:.3f} GB ({100 * err:+.1f}%); "
            f"collectives {dry['collectives']['per_op_count']}; meta run "
            f"{dry['lower_s']} s")
        if peak and not name.startswith("ecc"):
            check(abs(err) <= P15_PEAK_TOL, f"(d) {name} rank {k}: the dry "
                  f"run's peak is {100 * err:+.1f}% of the rank's")


# ----------------------------------------------------------------------------
# 16. the keyed draws (core.prng, the reference's jax.random)
# ----------------------------------------------------------------------------

P16_SEED = 16
#: (first element, elements, SHA-256 of the uint32 words little-endian) of
#: jax 0.9.0's `bits` under PRNGKey(16) (the second range by the threefry
#: primitive bound with its (hi, lo) count words)
P16_BITS = ((0, 1 << 26, "2a518b42a7daa27bfcb57af275230c50"
             "50ab35623166f96adb2b2e9e62cca237"),
            (2**32 - 2**25, 1 << 26, "e1a19853dbf39612d24c6e7992cb7844"
             "07b7b0c43ce888b9390380e2be85706d"))
#: jax 0.9.0's `bernoulli(PRNGKey(16), p, (draws,))`: p, draws, its flips
#: and the SHA-256 of their positions (uint64 little-endian)
P16_BERN = (1e-9, 1 << 28, 37, "4458a9fd9ae6ae2e15e0848b29837c5f"
            "7635a6b01b50b349c3d03846c9631324")
P16_ARCH = "phi3-mini-3.8b"
P16_P_BIT = 1e-5
P16_SCHEMES = (("ecc", ("encode_parity", "scrub")),
               ("hsiao", ("encode_hsiao", "scrub_hsiao")))


def keyed_bits(torch, prng, key, start, count):
    """`prng` bits of [start, start + count) on the key's device, chunked."""
    out = torch.empty(count, dtype=torch.int64, device=key.device)
    for s, c in prng.chunks(count):
        out[s:s + c] = prng._bits_range(key, start + s, c)
    return out


def sha256_le(torch, t, dtype: str) -> str:
    """SHA-256 of a tensor's values as little-endian `dtype` ("<u4")."""
    import hashlib
    return hashlib.sha256(t.cpu().numpy().astype(dtype).tobytes()
                          ).hexdigest()


def keyed_store_run(torch, spec, params, key):
    """protect, a keyed corrupt_store, scrub: (counters, read words)."""
    from repro_torch.core import arena
    from repro_torch.faults import TransientBitFlips
    from repro_torch.reliability import parse_scheme
    scheme = parse_scheme(spec)
    prot = scheme.protect(params)
    scheme.corrupt_store(prot, TransientBitFlips(P16_P_BIT), key)
    fixed, rep = scheme.scrub(prot)
    counts = (int(rep.corrected), int(rep.parity_fixed),
              int(rep.uncorrectable))
    return counts, arena.words_of(scheme.read(fixed))[0].cpu()


def run_prng_path(torch, card, dev):
    """Phase 16 (`tools/chip_phase.py 16`): the keyed draws on the card
    against the CPU and jax 0.9.0's digests (the phase list above).
    Returns its kernels' launches ((c)'s keyed stores)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import arena, prng
    from repro_torch.core import tree as T
    from repro_torch.models.params import materialize
    from repro_torch.models.transformer import model_specs
    cpu = torch.device("cpu")
    t_path = time.perf_counter()
    kd, kc = prng.key(P16_SEED, dev), prng.key(P16_SEED, cpu)

    # (a) bits across the 2^32 counter edge, the card against the CPU
    keyed_bits(torch, prng, kd, 0, prng.CHUNK)      # first launches
    for start, count, digest in P16_BITS:
        words, ms = timed_once(torch, lambda: keyed_bits(torch, prng, kd,
                                                         start, count))
        t0 = time.perf_counter()
        host = keyed_bits(torch, prng, kc, start, count)
        cpu_s = time.perf_counter() - t0
        check(torch.equal(words.cpu(), host),
              f"(a) bits from {start}: the card differs from the CPU")
        check(sha256_le(torch, words, "<u4") == digest,
              f"(a) bits from {start}: not jax 0.9.0's digest")
        log(f"phase 16 (a) bits [{start}, {start + count}): card {ms:.1f} ms "
            f"({count / ms / 1e6:.3f} G elements/s), CPU {cpu_s:.2f} s; "
            f"equal, jax 0.9.0's digest ({card})")
        del words, host

    # (b) the reference's Bernoulli floor at p 1e-9
    p, n, flips, digest = P16_BERN
    t = prng.threshold(p)

    def positions():
        return torch.cat([s + torch.nonzero(
            (prng._bits_range(kd, s, c) >> 9) < t).view(-1)
            for s, c in prng.chunks(n)])
    pos, ms = timed_once(torch, positions)
    check(pos.numel() == flips and sha256_le(torch, pos, "<u8") == digest,
          f"(b) bernoulli({p:g}) over {n}: {pos.numel()} flips, not the "
          f"reference's {flips} at its positions")
    log(f"phase 16 (b) bernoulli p={p:g} over 2^{n.bit_length() - 1} draws: "
        f"{pos.numel()} flips at the reference's positions (2^"
        f"{n.bit_length() - 1} * 2^-23 = {n * 2.0**-23:g}; at the nominal p "
        f"{n * p:.2f}); card {ms:.1f} ms "
        f"({n / ms / 1e6:.3f} G draws/s) ({card})")

    # (d) a keyed materialize of the smoke() model, the card against the CPU
    cfg = get_config(P16_ARCH).smoke()
    specs = model_specs(cfg)
    params_d, ms = timed_once(torch, lambda: materialize(specs, kd, "float32",
                                                          dev))
    t0 = time.perf_counter()
    params_c = materialize(specs, kc, "float32", cpu)
    cpu_s = time.perf_counter() - t0
    wd, wc = arena.words_of(params_d)[0].cpu(), arena.words_of(params_c)[0]
    check(torch.equal(wd, wc), f"(d) materialize: "
          f"{int((wd != wc).sum())} values of the card differ from the CPU's")
    log(f"phase 16 (d) keyed materialize of {cfg.name} smoke "
        f"({wd.numel()} words): equal to the CPU's; card {ms:.1f} ms, CPU "
        f"{cpu_s:.2f} s ({card})")
    # (c) keyed corrupt_store + scrub of the smoke() store, ecc and hsiao
    counts = {}
    for spec, names in P16_SCHEMES:
        params = T.map_tree(lambda x: x.clone(), params_d)
        kernels.reset_launch_counts()
        (got, words), ms = timed_once(torch, lambda: keyed_store_run(
            torch, spec, params, prng.key(P16_SEED + 1, dev)))
        launched = kernels.launch_counts()
        want, want_words = keyed_store_run(
            torch, spec, T.map_tree(lambda x: x.clone(), params_c),
            prng.key(P16_SEED + 1, cpu))
        for name in names:
            check(launched.get(name, 0) > 0,
                  f"(c) {spec}: {name} never launched")
            counts[name] = counts.get(name, 0) + launched.get(name, 0)
        check(got == want and torch.equal(words, want_words),
              f"(c) {spec}: card {got} != the CPU's {want}, or the read "
              f"payloads differ")
        check(got[0] > 0, f"(c) {spec}: nothing corrected")
        log(f"phase 16 (c) keyed corrupt_store + scrub of {cfg.name} smoke, "
            f"{spec}: counters (corrected, parity_fixed, uncorrectable) "
            f"{got} equal the CPU's, payload equal; launches "
            f"{ {k: launched.get(k, 0) for k in names} }; {ms:.1f} ms "
            f"({card})")

    log(f"phase 16: {time.perf_counter() - t_path:.1f} s ({card})")
    return counts


# ----------------------------------------------------------------------------
# 17. experts computed where they live, the store built from block ranges
# ----------------------------------------------------------------------------

#: (a): phi3.5-moe at full width, (arch, layers of 32), four gloo ranks
#: sharing the card as 4x1 with experts over data
P17A = ("phi3.5-moe-42b-a6.6b", 3)
#: (b): llama4-maverick at full width, one dense + MoE pair of its 48
#: layers, 4x1 over nccl on four cards under its serving rules
P17B = ("llama4-maverick-400b-a17b", 2)
P17_BATCH, P17_PROMPT, P17_GEN = 4, 256, 32
P17_P_BIT = 1e-9
P17_SEED = 17
#: bound on |meshed - one process| first-step logits and on (b)'s MoE
#: layer, as a share of the one process's largest |value|: the ranks run
#: the same products on the same per-expert shapes, so equality to the
#: bit is expected and the difference is printed
P17_REL = 1e-3
#: a rank's card
P17_CARD_BYTES = 80e9
#: smoke configs (a CPU rehearsal; never on the card)
P17_SMOKE = False


def p17_config(arch: str, depth: int, flash: bool = True):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.smoke() if P17_SMOKE else cfg.replace(n_layers=depth)
    return cfg.replace(attention_impl="pallas") if flash else cfg


def p17_knobs(strict: bool, moe_check: bool) -> dict:
    """What the rank function takes from this module's settings (a
    spawned rank imports the module afresh)."""
    return {"p_bit": P17_P_BIT, "seed": P17_SEED, "batch": P17_BATCH,
            "prompt": P17_PROMPT, "gen": P17_GEN, "strict": strict,
            "moe_check": moe_check}


#: bytes of whole experts (as stored) each step of the MoE check gathers
#: over every owner
P17_MOE_STEP_BYTES = 4e9


def p17_moe_layer(torch, cfg, store, mesh, rules, seed):
    """(b)'s MoE check on every rank: MoE layer 0 on its data group's row
    of a seeded (d, S, D) input with its own experts and, where ``ff`` is
    on model, its ff slice of each (expert and tensor parallelism), and
    the same layer recomputed here with no mesh from whole leaves: the
    shared expert gathered whole, the routed experts gathered a few at a
    time from every owner (its model group's ff slices joined), each of
    the d token groups routed, dispatched and combined alone, as its
    ranks do, the experts run on the d groups' stacked buffers.  Returns
    (mesh output of every row, the recomputation, the recomputation in
    fp32 where ff is split, else None), float32 on the host."""
    import dataclasses
    from repro_torch.core import tree as T
    from repro_torch.launch.placement import gathered
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import model_specs
    from repro_torch.pshard import split_of, use_mesh_and_rules
    d, row = mesh.shape["data"], mesh.coords["data"]
    p = gathered(store)["layers"][0]["moe"]
    # layer 0's specs: the stacked layer dimension dropped
    specs = T.map_tree(lambda sp: dataclasses.replace(
        sp, shape=sp.shape[1:], axes=sp.axes[1:]),
        model_specs(cfg)["layers"]["moe"])
    g = torch.Generator(device=mesh.device).manual_seed(seed)
    x = (torch.randn((d, P17_PROMPT, cfg.d_model), generator=g,
                     device=mesh.device) / 4).to(cfg.cdtype)

    def whole(t, spec, dims):
        # this rank's slice joined with its peers' along `dims` (by
        # position: the order of the ranks of each dimension's axes)
        for dim in dims:
            lead = t.dim() - len(spec.shape)
            if t.shape[dim] == spec.shape[dim - lead]:
                continue
            axes = split_of(spec.shape, spec.axes, dim - lead)[0]
            t = torch.cat(mesh.all_gather(t, axes), dim=dim)
        return t

    with torch.no_grad(), use_mesh_and_rules(mesh, rules, batch_shards=d):
        y = M.moe_apply(p, cfg, x[row:row + 1])[0]
        ys = torch.cat(mesh.all_gather(y, ("data",)))
        # every leaf whole but the routed experts (joined below)
        paths = T.paths(specs)
        pw = T.unflatten(paths, [
            p[q[0]] if q in (("w_up",), ("w_down",)) else
            whole(p[q[0]] if len(q) == 1 else p[q[0]][q[1]], sp,
                  range(len(sp.shape)))
            for q, sp in zip(paths, T.leaves(specs))])
        su, sd = specs["w_up"], specs["w_down"]
        split_ff = split_of(sd.shape, sd.axes, 1)[1] > 1
    up, down = p["w_up"], p["w_down"]
    el = up.shape[0]
    size = up.element_size() * math.prod(su.shape[1:]) \
        + down.element_size() * math.prod(sd.shape[1:])
    step = max(1, min(el, int(P17_MOE_STEP_BYTES // (d * size))))
    # each group's dispatch buffers, as its ranks form them
    bufs = []
    for r in range(d):
        M.moe_apply(pw, cfg, x[r:r + 1], experts=lambda b: (
            bufs.append(b), torch.zeros_like(b))[1])
    buf = torch.cat(bufs)                                   # (d, E, C, D)
    dtypes = (x.dtype,) + ((torch.float32,) if split_ff else ())
    outs = {dt: torch.empty(buf.shape, dtype=dt, device=buf.device)
            for dt in dtypes}
    for a in range(0, el, step):
        with use_mesh_and_rules(mesh, rules, batch_shards=d):
            u = whole(up[a:a + step], su, (2,))
            w = whole(down[a:a + step], sd, (1,))
            us = mesh.all_gather(u, ("data",))
            ws = mesh.all_gather(w, ("data",))
        del u, w
        for s in range(d):
            e = slice(s * el + a, s * el + a + us[s].shape[0])
            for dt in dtypes:
                outs[dt][:, e] = M._ffn(cfg, buf[:, e].to(dt), us[s].to(dt),
                                        ws[s].to(dt))
        del us, ws

    def recompute(dt):
        # the leaves as stored, or (exactly) in fp32
        pd = pw if dt == x.dtype else T.map_tree(lambda t: t.to(dt), pw)
        return torch.cat([M.moe_apply(pd, cfg, x[r:r + 1].to(dt),
                                      experts=lambda b: outs[dt][r:r + 1])[0]
                          for r in range(d)]).float().cpu().numpy()

    return (ys.float().cpu().numpy(), recompute(x.dtype),
            recompute(torch.float32) if split_ff else None)


def p17_moe_gate(what, ranks) -> None:
    """MoE layer 0 of every rank against its recomputation from whole
    leaves (`p17_moe_layer`): where ff is split, the rank's output no
    further from the fp32 recomputation than P13_BF16_RATIO times the
    bf16 recomputation is (the split rounds its partial sums once more),
    else within P17_REL of the bf16 recomputation."""
    for k, r in enumerate(ranks):
        ys, ref, ref32 = r["moe"]
        err = float(np.abs(ys - ref).max())
        if ref32 is None:
            tol = P17_REL * float(np.abs(ref).max())
            check(err <= tol, f"{what} rank {k}: MoE layer 0 differs from "
                  f"its recomputation by {err:.3g} > {tol:.3g}")
            msg = f"max abs err {err:.3g} (bound {tol:.3g})"
        else:
            base = float(np.abs(ref - ref32).max())
            got = float(np.abs(ys - ref32).max())
            tol = P13_BF16_RATIO * base
            check(got <= tol, f"{what} rank {k}: MoE layer 0 is {got:.3g} "
                  f"from its fp32 recomputation, > {P13_BF16_RATIO} x the "
                  f"bf16 recomputation's {base:.3g}")
            msg = (f"max abs err {got:.3g} against the fp32 recomputation "
                   f"({got / base:.3f}x the bf16 recomputation's {base:.3g};"
                   f" bound {tol:.3g}), {err:.3g} against the bf16 one, of "
                   f"a largest |value| {float(np.abs(ref32).max()):.3g}")
        log(f"{what} rank {k}: MoE layer 0 against its recomputation from "
            f"whole leaves: {msg}")


def p17_rank(dev, cfg, rules, runs, knobs):
    """One rank of a 4x1 world: per scheme the serve entry point on the
    mesh from a `core.prng` key whose ranges the ranks draw alone
    (`make_inputs(lazy=True)`; the clean run's tokens from the `off` run),
    the largest storage the build allocated, the first-step logits, one
    more guarded generate (host reads, collectives, its peak), and with
    `moe_check` (b)'s MoE layer check on the `off` store."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.launch.mesh import collectives_issued, make_test_mesh
    from repro_torch.launch.placement import (KeyedParams, LargestAllocation,
                                              LeafReads)
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.obs import count_host_transfers, fetch_telemetry
    from repro_torch.reliability import parse_scheme
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mesh = make_test_mesh(*knobs.get("shape", (4, 1)), device=dev)
    inputs = make_inputs(cfg, knobs["batch"], knobs["prompt"],
                         prng.key(knobs["seed"], dev), dev, lazy=True)
    if knobs.get("tame"):
        inputs["params"] = KeyedParams(tame_specs(cfg),
                                       prng.key(knobs["seed"], dev),
                                       cfg.param_dtype, dev)
    batch = {"tokens": inputs["tokens"]}
    out, clean = {}, None
    for name in runs:
        p_bit = knobs["p_bit"] if name != "off" else 0.0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        largest = LargestAllocation()
        res = serve(cfg, inputs["params"], inputs["tokens"],
                    parse_scheme(name), gen=knobs["gen"], p_bit=p_bit,
                    seed=SEED, device=dev, mesh=mesh, rules=rules,
                    reference=clean, watch_prepare=largest)
        launches = kernels.launch_counts()
        run_peak = torch.cuda.max_memory_allocated() if cuda else 0
        eng, store = res["engine"], res["store"]
        logits = p13_logits(torch, eng, store, batch)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        c0 = collectives_issued()
        reads = LeafReads() if knobs.get("reads") else None
        with count_host_transfers(strict=knobs["strict"]) as timed, \
                (reads or contextlib.nullcontext()):
            toks, tel = eng.generate(store, batch)
            sync()
        collectives = collectives_issued() - c0
        gen_peak = torch.cuda.max_memory_allocated() if cuda else 0
        with count_host_transfers(strict=knobs["strict"]) as fetched:
            fetch_telemetry(tel)
        check(torch.equal(toks, res["tokens"]),
              f"17 {name}: the guarded run's tokens differ")
        out[name] = {
            "tokens": res["tokens"].cpu().numpy(),
            "stats": {q: np.asarray(v) for q, v in res["stats"].items()},
            "logits": logits.cpu().numpy(), "tok_s": res["tok_s"],
            "prepare_s": res["prepare_s"], "agreement": res["agreement"],
            "syncs": (timed.syncs, fetched.syncs, timed.sites),
            "collectives": collectives, "launches": launches,
            "largest": largest.bytes, "run_peak": run_peak,
            "gen_peak": gen_peak, "local_words": store.words.numel(),
            "global_words": store.global_spec.n_words,
            "reads": None if reads is None else p18_reads(
                cfg, store, reads.reads)}
        if name == "off":
            clean = res["tokens"]
            if knobs["moe_check"]:
                out["moe"] = p17_moe_layer(torch, cfg, store, mesh, rules,
                                           knobs["seed"] + 1)
        del res, eng, store, toks, tel
    return out


def p17_range_kernels(torch, dev, n_words: int, what: str) -> None:
    """The four block-code kernels at one rank's block range (`n_words`
    random words, as a rank's build gives them to the kernels): each encode
    bit for bit against its plain version, each scrub's counters on the
    clean range against its plain version's, and every kernel timed
    (CUDA events) beside its bound and its plain version's time.  Not
    counted as the path's launches."""
    from repro_torch.kernels import diag_parity as D
    from repro_torch.kernels import hsiao_secded as H
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    words = random_words(torch, n_words, g, dev)
    nb = n_words // 32
    for names, enc, enc_ref, scrub, scrub_ref, rows, enc_ops, scrub_ops in (
            (("encode_parity", "scrub"), D.encode_parity,
             D.encode_parity_ref, D.scrub, D.scrub_ref, 3, 6, 8),
            (("encode_hsiao", "scrub_hsiao"), H.encode_hsiao,
             H.encode_hsiao_ref, H.scrub, H.scrub_hsiao_ref, 7, 21,
             HSIAO_SCRUB_OPS_PER_WORD)):
        parity = enc(words)
        plain, enc_plain_ms = rank_ms(torch, dev, lambda: enc_ref(words))
        check(torch.equal(parity, plain), f"{what}: {names[0]} kernel != "
              f"plain version")
        del plain
        enc_ms = time_ms(torch, lambda: enc(words))
        (_, _, counts_p), scrub_plain_ms = rank_ms(
            torch, dev, lambda: scrub_ref(words, parity.clone()))
        counts = scrub(words, parity)[2]
        check(torch.equal(counts, counts_p) and counts.tolist() == [0, 0, 0],
              f"{what}: scrub counts {counts.tolist()} on a clean range")
        scrub_ms = time_ms(torch, lambda: scrub(words, parity))
        eb = bound_ms(n_words * 4 + nb * rows * 4, enc_ops * n_words)
        sb = bound_ms(n_words * 4 + nb * rows * 4, scrub_ops * n_words)
        log(f"{what} ({n_words} words, {nb} blocks): {names[0]} kernel "
            f"{enc_ms:.3f} ms, plain {enc_plain_ms:.1f} ms, bound "
            f"{eb[0]:.3f} ms ({eb[1]}), bit-exact; {names[1]} kernel "
            f"{scrub_ms:.3f} ms (clean range), plain "
            f"{scrub_plain_ms:.1f} ms, bound {sb[0]:.3f} ms ({sb[1]})")
        del parity
    del words
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def p17_alone(torch, cfg, rules, runs, dev):
    """(a)'s comparison: one process holding every expert (the arena
    materialized whole from the same key) that serves the whole batch,
    forming the mesh's four token groups itself (`moe._dp_groups` under a
    4x1 ambient mesh), and then each row alone (its one group, as a rank
    holds it): per scheme tokens, counters and first-step logits of both."""
    from repro_torch.core import prng
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.pshard import AbstractMesh, use_mesh_and_rules
    from repro_torch.reliability import parse_scheme
    inputs = make_inputs(cfg, P17_BATCH, P17_PROMPT, prng.key(P17_SEED, dev),
                         dev)
    mesh = AbstractMesh((P17_BATCH, 1), ("data", "model"))
    out, clean = {}, None

    def one(name, tokens, ref):
        res = serve(cfg, inputs["params"], tokens, parse_scheme(name),
                    gen=P17_GEN, p_bit=P17_P_BIT if name != "off" else 0.0,
                    seed=SEED, device=dev, reference=ref)
        logits = p13_logits(torch, res["engine"], res["store"],
                            {"tokens": tokens})
        return res["tokens"], res["stats"], logits, res["tok_s"]

    for name in runs:
        with use_mesh_and_rules(mesh, rules):
            toks, stats, logits, tok_s = one(name, inputs["tokens"], clean)
        rows = []
        with use_mesh_and_rules(mesh, rules, batch_shards=P17_BATCH):
            for b in range(P17_BATCH):
                rows.append(one(name, inputs["tokens"][b:b + 1],
                                None if clean is None else clean[b:b + 1]))
        out[name] = {
            "tokens": toks.cpu().numpy(),
            "stats": {q: np.asarray(v) for q, v in stats.items()},
            "logits": logits.cpu().numpy(), "tok_s": tok_s,
            "row_tokens": np.concatenate([r[0].cpu().numpy() for r in rows]),
            "row_logits": np.concatenate([r[2].cpu().numpy()
                                          for r in rows])}
        clean = toks if clean is None else clean
    return out


def p17_range_words(cfg, n: int) -> int:
    """Words of rank 0's block range of `cfg`'s arena on n ranks."""
    from repro_torch.models.params import layout
    from repro_torch.models.transformer import model_specs
    return -(-layout(model_specs(cfg), cfg.param_dtype).n_blocks // n) * 32


def p17_build_reckon(cfg, scheme: str, n: int) -> float:
    """A 4x1 rank's build peak reckoned in bytes: its local arena (its
    quarter of the experts, every other leaf whole), its block range, the
    range's parity twice (the encode and the scrub's copy) and the
    all-gather's n + 1 pieces (`placement.STEP` words each)."""
    from repro_torch.core import tree as T
    from repro_torch.launch.placement import STEP
    from repro_torch.models.params import layout
    from repro_torch.models.transformer import model_specs
    specs = model_specs(cfg)
    spec = layout(specs, cfg.param_dtype)
    local = sum(math.prod(l.shape) // (n if "expert" in s.axes else 1)
                for l, s in zip(spec.leaves, T.leaves(specs)))
    rng = p17_range_words(cfg, n)
    checks = {"ecc": 3, "hsiao": 7}.get(scheme, 0)
    return 4 * (local + rng + 2 * rng * checks / 32 + (n + 1) * min(STEP,
                                                                    rng))


def p17_dry(cfg, scheme: str, rules, shape=(4, 1), gen=P17_GEN,
            peer_views=False):
    """The dry run of a `shape` rank's generate (`dryrun.engine_cell`,
    rank 0: every rank's shards have its shapes), its blocked attention
    standing for flash (``meta`` has no kernel); `peer_views` for ranks
    sharing one card."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import RecordingMesh
    return D.engine_cell(cfg.replace(attention_impl="blocked"), scheme,
                         RecordingMesh(shape, ("data", "model"),
                                       peer_views=peer_views),
                         batch=P17_BATCH, prompt_len=P17_PROMPT, gen=gen,
                         rules=rules)


def p17_gates(what, ranks, runs, card: bool, alone=None, dry=None,
              reckoned=None):
    """Tokens against the clean run (and against one process's, with its
    counters and logits), corrections > 0 and uncorrectable 0 under a
    code, the host reads, on the `card` the largest allocation under the
    whole arena (off it, a plain scrub's chunk of temporaries can outweigh
    a smoke arena), and with `dry`, the exchanges exact, the generate's
    peak within P15_PEAK_TOL of the dry run's and the run's under the
    card."""
    clean = ranks[0]["off"]["tokens"]
    for k, r in enumerate(ranks):
        for name in runs:
            got = r[name]
            tag = f"{what} {name} rank {k}"
            check(np.array_equal(got["tokens"], clean),
                  f"{tag}: tokens differ from the clean run's")
            if name != "off":
                check(int(got["stats"]["ecc_corrected"]) > 0 and
                      int(got["stats"]["ecc_uncorrectable"]) == 0,
                      f"{tag}: counters {got['stats']}")
            timed, fetched, sites = got["syncs"]
            check(timed == 0 and fetched == 1, f"{tag}: {timed} host reads "
                  f"in the timed region {sites}, {fetched} for the fetch")
            whole = 4 * got["global_words"]
            check(not card or 0 < got["largest"] < whole,
                  f"{tag}: the build allocated "
                  f"{got['largest']} bytes at once, the arena is {whole}")
            msg = (f"{tag}: prepare {got['prepare_s']:.2f} s, "
                   f"{got['tok_s']:.1f} tok/s, largest allocation of the "
                   f"build {got['largest'] / 1e9:.3f} GB of a "
                   f"{whole / 1e9:.2f} GB arena, local store "
                   f"{4 * got['local_words'] / 1e9:.2f} GB, run peak "
                   f"{got['run_peak'] / 1e9:.3f} GB"
                   + (f" (reckoned {reckoned[name] / 1e9:.3f})"
                      if reckoned else "")
                   + f", generate peak {got['gen_peak'] / 1e9:.3f} GB, "
                   f"{got['collectives']} collectives in a generate, "
                   f"counters { {q: int(v.sum()) for q, v in got['stats'].items()} }"
                   f", launches {got['launches']}")
            if alone is not None:
                a = alone[name]
                tol = P17_REL * float(np.abs(a["logits"]).max())
                err = float(np.abs(got["logits"] - a["logits"]).max())
                err_rows = float(np.abs(got["logits"]
                                        - a["row_logits"]).max())
                split = float(np.abs(a["row_logits"] - a["logits"]).max())
                top2 = np.sort(a["logits"], axis=-1)[..., -2:]
                gap = (top2[..., 1] - top2[..., 0]).reshape(-1)
                same = (got["tokens"] == a["tokens"]).all(axis=1)
                same_rows = (got["tokens"] == a["row_tokens"]).all(axis=1)
                log(f"{tag}: first-step logits max abs err {err:.3g} "
                    f"against the whole batch, {err_rows:.3g} against each "
                    f"row alone (one process: rows alone against the batch "
                    f"{split:.3g}; bound {tol:.3g}); tokens equal the "
                    f"batch's in {int(same.sum())}/{same.size} rows, the "
                    f"rows alone's in {int(same_rows.sum())}/"
                    f"{same_rows.size} (top-two gaps "
                    f"{np.round(gap, 3).tolist()}; one process "
                    f"{a['tok_s']:.1f} tok/s)")
                # the whole batch's 1,024-row products round otherwise
                # than a rank's 256-row ones (bf16, cuBLAS's choice by
                # shape): the exact comparison is each row served alone
                # by the one process, whose tokens group is the rank's
                check_same_run(got, a, tag, tokens=False)
                check(err_rows <= tol, f"{tag}: logits differ from the rows "
                      f"alone by {err_rows:.3g} > {tol:.3g}")
                check(np.array_equal(got["tokens"], a["row_tokens"]),
                      f"{tag}: tokens differ from the rows served alone")
                msg += ("; tokens equal one process's rows served alone, "
                        "counters equal its")
            if dry is not None:
                d = dry[name]
                n = sum(d["collectives"]["per_op_count"].values())
                check(n == got["collectives"], f"{tag}: the dry run records "
                      f"{n} exchanges, the rank made {got['collectives']}")
                check(got["run_peak"] < P17_CARD_BYTES,
                      f"{tag}: run peak {got['run_peak'] / 1e9:.2f} GB")
                if got["gen_peak"]:
                    err = d["peak_bytes"] / got["gen_peak"] - 1
                    check(abs(err) <= P15_PEAK_TOL, f"{tag}: the dry run's "
                          f"generate peak {d['peak_bytes'] / 1e9:.3f} GB is "
                          f"{100 * err:+.1f}% of the rank's")
                    msg += (f"; dry run: generate peak "
                            f"{d['peak_bytes'] / 1e9:.3f} GB ({100 * err:+.1f}"
                            f"%), {n} exchanges {d['collectives']['per_op_count']}")
            log(msg)


def run_expert_mesh_path(torch, card, dev):
    """Phase 17 (a) (`tools/chip_phase.py 17`): phi3.5-moe at full width,
    P17A[1] layers, four gloo ranks sharing the card as 4x1 with experts
    over data (its rules with ``expert`` over data and ``model_dim``
    replicated), batch 4 x 256, gen 32, flash, under `off` and `ecc` at
    p_bit 1e-9, every rank's store built from its block range of a keyed
    arena, against one process with the whole batch forming the same four
    token groups from the same key.  Returns the ranks' launches."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.specs import arch_rules
    from repro_torch.models.params import fill_range
    from repro_torch.models.transformer import model_specs
    from repro_torch.core import prng
    t_path = time.perf_counter()
    cfg = p17_config(*P17A)
    rules = arch_rules(cfg.name, extra={"expert": ("data",),
                                        "model_dim": ()})
    runs = ("off", "ecc")
    # the keyed draw of a range, alone: the build's materialization rate
    n = 1 << 26 if not P17_SMOKE else 1 << 12
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    key = prng.key(P17_SEED, dev)
    fill_range(model_specs(cfg), key, buf, 0)
    _, ms = rank_ms(torch, dev, lambda: fill_range(model_specs(cfg), key,
                                                   buf, n))
    log(f"phase 17 (a): keyed fill of {n} arena words (normals) in "
        f"{ms:.1f} ms ({n / ms / 1e6:.3f} G words/s) ({card})")
    del buf
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    copy = p11_copy_bytes(cfg) / 1e9
    log(f"phase 17 (a): {cfg.name} at {cfg.n_layers} layers, a copy is "
        f"{copy:.2f} GB; each of 4 ranks builds its quarter range and holds "
        f"a quarter of the experts")
    p17_range_kernels(torch, dev, p17_range_words(cfg, 4),
                      "phase 17 (a) a rank's range")
    t0 = time.perf_counter()
    ranks = spawn(p17_rank, 4, args=(cfg, rules, runs,
                                     p17_knobs(False, False)),
                  device=dev.type)
    log(f"phase 17 (a): 4 gloo ranks in {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        check_peaks_within_parity("phase 17 (a)", ranks, cfg, 4)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    alone = p17_alone(torch, cfg, rules, runs, dev)
    log(f"phase 17 (a): one process in {time.perf_counter() - t0:.1f} s")
    p17_gates("phase 17 (a) 4x1 gloo", ranks, runs, dev.type == "cuda",
              alone=alone)
    total = {}
    for k, r in enumerate(ranks):
        for name in runs:
            need = ["flash_attention"] + (["encode_parity", "scrub"]
                                          if name == "ecc" else [])
            check_launched(r[name]["launches"], need,
                           f"phase 17 (a) {name} rank {k}")
            add_launches(total, r[name]["launches"])
    log(f"phase 17 (a): {time.perf_counter() - t_path:.1f} s, launches "
        f"{total} ({card})")
    return total


def run_expert_mesh_four(torch, card, dev):
    """Phase 17 (b) (`tools/chip_phase.py 17b`, four cards on one host):
    llama4-maverick at full width, one dense + MoE pair, 4x1 over nccl
    under its serving rules, batch 4 x 256, gen 32, flash, under `off`,
    `ecc` and `hsiao` at p_bit 1e-9, every rank's store from its block
    range of a keyed arena.  Gates: tokens equal the clean run's,
    corrections > 0 and uncorrectable 0, run peaks under the card, the
    generate's peak within 10% of the dry run's and its exchanges equal,
    0 host reads in the timed region under the strict guard, and MoE
    layer 0 against its recomputation from whole leaves (`p17_moe_gate`).
    Returns the ranks' launches."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.specs import arch_rules
    t_path = time.perf_counter()
    check(dev.type != "cuda" or torch.cuda.device_count() >= 4,
          "phase 17 (b) needs four cards")
    cfg = p17_config(*P17B)
    rules = arch_rules(cfg.name, serve=True)
    runs = ("off", "ecc", "hsiao")
    dry = {name: p17_dry(cfg, name, rules) for name in runs}
    reckoned = {name: p17_build_reckon(cfg, name, 4) for name in runs}
    copy = p11_copy_bytes(cfg) / 1e9
    log(f"phase 17 (b): {cfg.name} at {cfg.n_layers} of 48 layers, the "
        f"arena is {copy:.2f} GB; build peaks reckoned "
        f"{ {q: round(v / 1e9, 3) for q, v in reckoned.items()} } GB a rank; "
        f"dry-run generate peaks "
        f"{ {q: round(d['peak_bytes'] / 1e9, 3) for q, d in dry.items()} } "
        f"GB ({card})")
    p17_range_kernels(torch, dev, p17_range_words(cfg, 4),
                      "phase 17 (b) a rank's range")
    t0 = time.perf_counter()
    ranks = spawn(p17_rank, 4, args=(cfg, rules, runs,
                                     p17_knobs(dev.type == "cuda", True)),
                  device=dev.type)
    log(f"phase 17 (b): 4 ranks in {time.perf_counter() - t0:.1f} s")
    p17_gates("phase 17 (b) 4x1 nccl", ranks, runs, dev.type == "cuda",
              dry=dry, reckoned=reckoned)
    p17_moe_gate("phase 17 (b) 4x1 nccl", ranks)
    total = {}
    for k, r in enumerate(ranks):
        for name in runs:
            need = ["flash_attention"] + {
                "ecc": ["encode_parity", "scrub"],
                "hsiao": ["encode_hsiao", "scrub_hsiao"]}.get(name, [])
            check_launched(r[name]["launches"], need,
                           f"phase 17 (b) {name} rank {k}")
            add_launches(total, r[name]["launches"])
    log(f"phase 17 (b): {time.perf_counter() - t_path:.1f} s, launches "
        f"{total} ({card})")
    return total


# ----------------------------------------------------------------------------
# 18. heads, ff and vocab computed where they live on the serving mesh
# ----------------------------------------------------------------------------

#: (a): (arch, layers, meshes, rules beyond the arch's), gloo ranks
#: sharing the card, fp32 compute (the CPU test's logits bound holds)
P18A = (("phi3-mini-3.8b", 4, ((1, 2), (2, 2)), {}),
        ("phi3.5-moe-42b-a6.6b", 3, ((2, 2),),
         {"expert": ("data",), "ff": ("model",), "model_dim": ()}))
#: (b): (arch, layers, mesh, runs), four cards over nccl, each arch's
#: serving rules, bf16 compute
P18B = (("llama4-maverick-400b-a17b", 2, (2, 2), ("off", "ecc", "hsiao")),
        ("phi3-mini-3.8b", 32, (1, 4), ("off", "ecc")))
P18A_GEN = 8
#: (a)'s bound on |meshed - one process| logits, a share of the largest
P18_REL = 1e-5
#: the leaves whose head, ff or vocab dimension the rules put on model
P18_SPLIT = ("wq", "wkv", "wo", "w_up", "w_down", "head")
#: phase 17 (b)'s counters (corrected, parity fixed, uncorrectable) on
#: the same arena, key and faults (PERF.md): a total over the
#: ranks, whatever their block ranges
P17B_COUNTERS = (621, 0, 0)
#: flash at a rank's heads: (what, B, S, H, KV, hd)
P18_FLASH = (("a maverick 2x2 rank", 2, 256, 20, 4, 128),
             ("a phi3-mini 1x4 rank", 4, 256, 8, 8, 96),
             ("a phi3-mini 2x2 rank", 2, 256, 16, 16, 96))
#: smoke configs (a CPU rehearsal; never on the card)
P18_SMOKE = False


def p18_config(arch: str, depth: int, compute_dtype=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.smoke() if P18_SMOKE else cfg.replace(n_layers=depth)
    cfg = cfg.replace(attention_impl="pallas")
    return cfg.replace(compute_dtype=compute_dtype) if compute_dtype else cfg


def p18_reads(cfg, store, reads) -> dict:
    """A rank's reads of the `P18_SPLIT` leaves in a generate
    (`placement.LeafReads`): each must be its 1 / model slice along every
    head, ff or vocab dimension, and allocate nothing as large as the
    whole layer's leaf (in the params' dtype) from that read to the next.
    Returns the reads counted, the first of each kind of violation and
    the largest window with its leaf."""
    from repro_torch.core import tree as T
    from repro_torch.models.transformer import model_specs
    specs = T.leaves(model_specs(cfg))
    paths = store.global_spec.paths
    n_model = store.mesh.shape["model"]
    elem = 4 if cfg.param_dtype == "float32" else 2
    whole_read, large, n, top = [], [], 0, (0, "")
    for li, shape, largest in reads:
        path = paths[li]
        if path[-1] not in P18_SPLIT:
            continue
        spec, lead = specs[li], len(shape) - len(specs[li].shape)
        whole = elem * math.prod(spec.shape[-lead:])
        dims = [d for d, a in enumerate(spec.axes)
                if a in ("heads", "kv_heads", "ff", "vocab")]
        n += 1
        what = ("/".join(path), shape, largest, whole)
        if not all(shape[d + lead] * n_model == spec.shape[d]
                   for d in dims):
            whole_read.append(what)
        if largest >= whole:
            large.append(what)
        top = max(top, (largest, "/".join(path)))
    return {"n": n, "whole": whole_read[:5], "large": large[:5],
            "largest": top}


def p18_alone(torch, cfg, rules, runs, shape, gen, dev, seed=P17_SEED):
    """(a)'s comparison: one process holding every expert (the arena drawn
    whole from the same key, at TAME_STD) that serves each data group's
    rows alone,
    as that group's ranks hold them (`moe._dp_groups` under an ambient
    `shape` mesh with no processes): per scheme the tokens, counters and
    first-step logits of the rows in order."""
    from repro_torch.core import prng
    from repro_torch.launch.placement import KeyedParams
    from repro_torch.launch.serve import make_inputs, serve
    from repro_torch.pshard import AbstractMesh, use_mesh_and_rules
    from repro_torch.reliability import parse_scheme
    key = prng.key(seed, dev)
    inputs = make_inputs(cfg, P17_BATCH, P17_PROMPT, key, dev, lazy=True)
    inputs["params"] = KeyedParams(tame_specs(cfg), key, cfg.param_dtype,
                                   dev).materialize()
    mesh = AbstractMesh(shape, ("data", "model"))
    d = shape[0]
    per = P17_BATCH // d
    out, clean = {}, None
    for name in runs:
        parts = []
        for g in range(d):
            rows = slice(g * per, (g + 1) * per)
            tokens = inputs["tokens"][rows]
            with use_mesh_and_rules(mesh, rules, batch_shards=d):
                res = serve(cfg, inputs["params"], tokens, parse_scheme(name),
                            gen=gen, p_bit=P17_P_BIT if name != "off" else 0.0,
                            seed=SEED, device=dev,
                            reference=None if clean is None else clean[rows])
                logits = p13_logits(torch, res["engine"], res["store"],
                                    {"tokens": tokens})
            parts.append((res["tokens"], res["stats"], logits, res["tok_s"]))
            del res
        toks = torch.cat([p[0] for p in parts])
        # one store serves every group: its counters once, the tokens all
        stats = {q: np.asarray(v) for q, v in parts[0][1].items()}
        stats["tokens_emitted"] = np.asarray(toks.numel(), np.int32)
        out[name] = {
            "tokens": toks.cpu().numpy(), "stats": stats,
            "logits": torch.cat([p[2] for p in parts]).cpu().numpy(),
            "tok_s": sum(p[3] for p in parts) / d}
        clean = toks if clean is None else clean
    return out


def p18_gates(what, ranks, runs, shape, dry, card: bool, alone=None):
    """Phase 17's gates (tokens against the clean run, counters, host
    reads, the build's largest allocation under the arena; over nccl the
    dry run's exchanges exact and its generate peak within P15_PEAK_TOL),
    then the reads' (`p18_reads`); with `alone` (ranks sharing the card:
    no peak gate) the exchanges equal the dry run's, tokens and counters
    equal one process's and logits within P18_REL of its largest."""
    p17_gates(what, ranks, runs, card, dry=None if alone else dry)
    for k, r in enumerate(ranks):
        for name in runs:
            got, tag = r[name], f"{what} {name} rank {k}"
            if alone is not None:
                want = sum(dry[name]["collectives"]["per_op_count"].values())
                check(got["collectives"] == want, f"{tag}: the dry run "
                      f"records {want} exchanges, the rank made "
                      f"{got['collectives']}")
            reads = got["reads"]
            check(reads["n"] > 0 and not reads["whole"], f"{tag}: reads of "
                  f"whole leaves {reads['whole']}")
            # off the card a smoke leaf weighs less than the activations
            check(not card or not reads["large"], f"{tag}: windows as "
                  f"large as the whole leaf {reads['large']}")
            msg = (f"{tag}: {reads['n']} reads of {P18_SPLIT}, each a "
                   f"1/{shape[1]} slice; largest window "
                   f"{reads['largest'][0] / 1e6:.1f} MB "
                   f"({reads['largest'][1]})")
            if alone is not None:
                a = alone[name]
                tol = P18_REL * float(np.abs(a["logits"]).max())
                err = float(np.abs(got["logits"] - a["logits"]).max())
                check_same_run(got, a, tag, tokens=True)
                check(err <= tol, f"{tag}: logits differ from one process's "
                      f"by {err:.3g} > {tol:.3g}")
                msg += (f"; tokens and counters equal one process's, logits "
                        f"max abs err {err:.3g} (bound {tol:.3g}), "
                        f"{got['tok_s']:.1f} tok/s ({a['tok_s']:.1f} one "
                        f"process)")
            log(msg)


def p18_world(torch, dev, cfg, rules, runs, shape, gen, strict, peer_views,
              tame=False, moe_check=False, seed=P17_SEED):
    """One world of `shape` (`p17_rank` with the reads recorded; with
    `tame`, weights at TAME_STD; with `moe_check`, MoE layer 0 against
    its recomputation from whole leaves) and its dry run: (ranks, dry run
    per scheme)."""
    from repro_torch.launch.mesh import backend_for, spawn
    n = shape[0] * shape[1]
    dry = {name: p17_dry(cfg, name, rules, shape, gen, peer_views)
           for name in runs}
    knobs = {**p17_knobs(strict, moe_check), "gen": gen, "shape": shape,
             "reads": True, "tame": tame, "seed": seed}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(p17_rank, n, args=(cfg, rules, runs, knobs),
                  device=dev.type)
    log(f"phase 18 {cfg.name} {shape[0]}x{shape[1]}: {n} ranks "
        f"({backend_for(dev, n)}) in {time.perf_counter() - t0:.1f} s; dry "
        f"run generate peaks "
        f"{ {q: round(d['peak_bytes'] / 1e9, 3) for q, d in dry.items()} } "
        f"GB, exchanges "
        f"{ {q: d['collectives']['per_op_count'] for q, d in dry.items()} }")
    return ranks, dry


def run_tensor_mesh_path(torch, card, dev):
    """Phase 18 (a) (`tools/chip_phase.py 18`): flash at a rank's heads,
    then each P18A config on each of its meshes, four or two gloo ranks
    sharing the card, against one process (module doc).  Returns the
    ranks' launches."""
    from repro_torch.launch.specs import arch_rules
    t_path = time.perf_counter()
    worst = check_flash_zoo(torch, dev, P18_FLASH)
    log(f"phase 18: flash at a rank's heads, max abs err {worst:.3g} "
        f"({card})")
    total, runs = {}, ("off", "ecc")
    for arch, depth, meshes, extra in P18A:
        cfg = p18_config(arch, depth, "float32")
        rules = arch_rules(arch, extra=extra)
        for shape in meshes:
            ranks, dry = p18_world(torch, dev, cfg, rules, runs, shape,
                                   P18A_GEN, False, True, tame=True)
            t0 = time.perf_counter()
            alone = p18_alone(torch, cfg, rules, runs, shape, P18A_GEN, dev)
            log(f"phase 18 (a) {arch} {shape[0]}x{shape[1]}: one process in "
                f"{time.perf_counter() - t0:.1f} s")
            what = f"phase 18 (a) {arch} {shape[0]}x{shape[1]} gloo"
            p18_gates(what, ranks, runs, shape, dry, dev.type == "cuda",
                      alone)
            if dev.type == "cuda":
                check_peaks_within_parity(what, ranks, cfg,
                                          shape[0] * shape[1])
            for k, r in enumerate(ranks):
                for name in runs:
                    need = ["flash_attention"] + (
                        ["encode_parity", "scrub"] if name == "ecc" else [])
                    if dev.type == "cuda":
                        check_launched(r[name]["launches"], need,
                                       f"{what} {name} rank {k}")
                    add_launches(total, r[name]["launches"])
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    log(f"phase 18 (a): {time.perf_counter() - t_path:.1f} s, launches "
        f"{total} ({card})")
    return total


def run_tensor_mesh_four(torch, card, dev):
    """Phase 18 (b) (`tools/chip_phase.py 18b`, four cards on one host):
    each P18B config on its mesh over nccl under its serving rules, bf16,
    batch 4 x 256, gen 32, from a keyed arena (module doc); maverick's
    counters equal phase 17 (b)'s.  Returns the ranks' launches."""
    from repro_torch.launch.specs import arch_rules
    t_path = time.perf_counter()
    check(dev.type != "cuda" or torch.cuda.device_count() >= 4,
          "phase 18 (b) needs four cards")
    total = {}
    for arch, depth, shape, runs in P18B:
        cfg = p18_config(arch, depth)
        rules = arch_rules(arch, serve=True)
        copy = p11_copy_bytes(cfg) / 1e9
        log(f"phase 18 (b): {arch} at {cfg.n_layers} layers as "
            f"{shape[0]}x{shape[1]}, the arena is {copy:.2f} GB ({card})")
        moe = cfg.moe_experts > 0
        ranks, dry = p18_world(torch, dev, cfg, rules, runs, shape, P17_GEN,
                               dev.type == "cuda", False, moe_check=moe)
        what = f"phase 18 (b) {arch} {shape[0]}x{shape[1]} nccl"
        p18_gates(what, ranks, runs, shape, dry, dev.type == "cuda")
        if moe:
            p17_moe_gate(what, ranks)
        for k, r in enumerate(ranks):
            for name in runs:
                if arch.startswith("llama4") and name != "off" and \
                        not P18_SMOKE:
                    got = tuple(int(r[name]["stats"][q]) for q in (
                        "ecc_corrected", "ecc_parity_fixed",
                        "ecc_uncorrectable"))
                    check(got == P17B_COUNTERS, f"{what} {name} rank {k}: "
                          f"counters {got}, phase 17 (b)'s {P17B_COUNTERS}")
                need = ["flash_attention"] + {
                    "ecc": ["encode_parity", "scrub"],
                    "hsiao": ["encode_hsiao", "scrub_hsiao"]}.get(name, [])
                if dev.type == "cuda":
                    check_launched(r[name]["launches"], need,
                                   f"{what} {name} rank {k}")
                add_launches(total, r[name]["launches"])
    log(f"phase 18 (b): {time.perf_counter() - t_path:.1f} s, launches "
        f"{total} ({card})")
    return total

if __name__ == "__main__":
    sys.exit(main())
