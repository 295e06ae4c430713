#!/usr/bin/env python3
"""Drive the PyTorch port end to end on one NVIDIA GPU and check it.

    python3 chip_smoke.py                   # the smoke run
    python3 chip_smoke.py --planted-faults [NAME ...]  # the kernel checks
                                            # catch faults (all, or those)
    python3 chip_smoke.py --ab PARENT CHANGE [attention sampling gemm grammar
                                             lora | sampler]
                                            # kernel times of two trees
    python3 chip_smoke.py --serve-qos       # serve_qos alone

Phases, each printing one JSON line; any failure exits non-zero and
prints no result:

  1. device   the card (nvidia-smi name and power limit), torch and CUDA;
  2. build    every kernel of the serving path built from ``csrc/`` with
              one nvcc per source, all at once; registers and spills of
              every instance, the SASS counts of HGMMA (wgmma) and UTMALDG
              (TMA loads) in each W8A16 GEMM kernel (every bf16 instance
              must hold both) and the clusters of 1 to 8 CTAs the card
              runs at once;
  3. kernel:flash_prefill                kernel vs its plain version at
  4. kernel:ragged_paged_attention       the main paths' shapes, with
  5. kernel:ragged_paged_attention_int8  times, bounds and a library
  6. kernel:ragged_decode                yardstick;
  7. kernel:sample_slots  the sampler, one launch a sampling call (keys,
              live settings, top-k/top-p bisection, draw, logprob) at
              R = 72, 8 and 40 rows (8 slots x W) of llama3-8b's
              vocabulary, float32 and bfloat16 logits, slots mixing
              greedy, temperature 0.7, top-k 50, top-p 0.9, the chain
              server's 0.2 / 0.7, both filters, top-p 0 and top-k past the
              vocabulary, some inactive, with degenerate rows: thr_k
              bit-equal to the plain version's, thr_p and tokens equal off
              the counted near-ties, logprobs within 1e-5, threefry bits
              exact; times beside the bound of the work these inputs need,
              the plain version and a sort-based torch yardstick; then its
              options: an allowed bitmask with the rows' states, rows 2
              and 6 of every 8 unconstrained with zero words
              (``mask_rows8``: every drawn token on the mask, the
              unconstrained rows drawn unmasked), the DFA advance (``advance_rows8``:
              each slot's next state that of its own token), the top rows
              (``top_rows40``: bf16 rows with forced ties, ids equal ties
              included, logprobs within 1e-5, beside ``torch.topk`` +
              ``torch.logsumexp``) and all three (``all_rows72``, and
              ``all_slots12_rows108`` at serve_tools' 12 slots of W = 9);
              then Gemma's 256,000 entries (``gemma_rows72``, ``_rows8``,
              ``_rows40``, and all three options at 8 and 72 rows), where
              a block keeps s alone and recomputes e each top-p round;
  7c. kernel:grammar_mask  the allowed set of a grammared sampling call
              at R = 8, 40 and 72 rows (8 slots) and 108 (serve_tools' 12
              slots of W = 9) of llama3's 128,256 entries, rows w >
              0 unconstrained, over the engine's 4-slot flat table holding
              ``json_value()``, a nested schema, a tool set and a grammar
              registered over an evicted one, with the byte table of the
              smoke's Llama-3-shaped tokenizer (uint8 bytes, int8
              lengths); then 12 slots all constrained (``all_rows12``), a
              fail-safe row and an accepting one (``failsafe_rows8``) and
              two launches on the same buffers (``two_launches``): the
              output zeroed before each checked launch, constrained rows
              bit for bit the plain version's, unconstrained rows never
              written, the sampler over that mask equal to the plain
              sampler; timed beside the plain version, the bound and the
              fixed cost of an empty launch on the same grid
              (``floor_ms``);
  7d. kernel:lora  the per-row LoRA update (``lora_apply_group``, one
              call for the targets that share an input) at llama3-8b's
              projection shapes: rank 16 on wq/wo, wk/wv, gate/up and
              down at 8, 72 and 4,096 rows with the slots mixed (the base
              model and three adapters), rank 8 on wq and wk, all base
              rows and all one adapter at decode and prefill, a global
              adapter and the f32 instance, the groups wq|wk|wv and
              gate|up at 8, 72 and 4,096 rows, and llama3-70b's wq,
              gate/up and down at 8 and 584 rows; slot 0 holds random
              values there (never read: base rows come out bit-equal),
              every target within ``LORA_TOLERANCE`` of the plain
              version; timed beside the plain version, the reference's
              formulation in eager PyTorch (once a target) and the bound,
              and the host's time a call through the model's seam;
  7b. kernel:w8a16_gemm  the W8A16 GEMM (int8 weights, bf16 or f32
              activations) at every weight shape of llama3-8b (8, 40, 72
              and 4,096 rows) and of llama3-70b (8, 72, 4,096 and the 584
              rows of its mixed dispatch), bf16, and one f32 case, within
              ``GEMM_TOLERANCE`` of its plain version; device times over
              enough weight copies to pass L2 and host us a call, beside
              the bound, the plain version and ``F.linear`` over the
              dequantized weight, and each case's tile plan;
  8. parity   llama3-8b width, 2 layers, f32, greedy: the kernel path and
              the plain path give the same tokens through the engine over
              a model-dtype pool and an int8 pool, on the narrow path (one
              dispatch in flight, no hold, no ladder, speculation and the
              mixed dispatch off) and with speculation and the mixed
              dispatch on (a prompt arriving mid-decode), the latter the
              former's tokens, and the dense-cache API kernel vs plain;
              then (``parity_prefix``) the prefix cache on against off on
              the kernel path, both pools; then (``parity_pipeline``) the
              defaults (two dispatches in flight, the prefill hold, the
              width ladder, the sampling kernel) against the plain
              sampler (which must launch no ``sample_slots``), against ``pipeline_depth`` 1, against the ladder
              off and against a device that lags (two dispatches then
              stay in flight), greedy and seeded sampled streams token
              for token; then ``parity_w8``: int8 weights at that width,
              both pools, the kernel path (``w8a16_gemm``'s f32 instance
              and the attention kernels) against the plain path; then
              ``parity_lora``: three adapters (rank 16 on all seven
              targets) registered, a batch of the base model and each
              adapter, greedy and seeded, kernel path against plain path
              (logits of a grouped prefill, then every stream), and each
              adapter's requests alone on a global-adapter engine equal
              to the batch's; ``dense_lora``: the dense-cache API with a
              global adapter, 8 rows, kernel against plain; then
              ``parity_gemma``: gemma-7b's and gemma-2b's widths (heads of
              256, G = 1 and 8, V = 256,000), 2 layers, f32, the kernel
              path against the plain path: a dense prefill's logits within
              ``PARITY_GAP_TOL``, greedy engine streams over both pools
              with speculation and the mixed dispatch on; then
              ``parity_multi``: multi-step decode (``decode_multistep``
              4, K 8) at llama3-8b width, 2 layers, f32, both pools,
              three greedy requests over the smoke's BPE tokenizer, one
              with a stop string cut from its own per-step stream and one
              that never matches on its most frequent character: the
              kernel path's multi-step streams equal its per-step ones
              (finish reasons too) and the plain path's, a stop-bearing
              slot emits nothing after its first suspect token in a block
              (``_pause_check``), and the attention kernel and
              ``sample_slots`` launch inside the multi-step dispatches;
              then ``parity_disagg``: the KV handoff at llama3-8b width, 2
              layers, f32, by hand-driven schedulers: a 14-page and a 2-page
              prompt, greedy and seeded, prefilled by a ``role=prefill``
              scheduler, their pages imported into a throwaway pool in
              reverse order and exported again bit for bit, then imported
              by a ``role=decode`` one whose streams equal its own unified
              ones; and a seeded stream evacuated once 8 tokens came and
              resumed on a peer, equal to the unevacuated one;
              then ``parity_encoders``: the Embedder and the Reranker on
              the card at e5-base's width (768, 12 heads, F 3,072), 2
              layers, f32, against ``bert.embed`` / ``bert.rank_score`` on
              the CPU over inputs this script packs (embeddings within
              1e-4, logits within 1e-3, the order equal off near-ties),
              and an IVF store on the card (20,000 clustered rows, every
              cell probed, an incremental add, a third deleted) whose
              top-10 equals a float64 numpy brute force (scores within
              1e-5, ranks swapped only at near-ties);
              ``parity_moe`` (after ``parity_gemma``): mixtral-8x7b's
              widths (8 experts of hidden 14,336, top-2, capacity factor
              1.25, V = 32,000), 2 layers, f32: a dense prefill's and a
              dense ``decode_step``'s logits, kernel attention against
              plain, within ``PARITY_GAP_TOL``; greedy engine streams over
              both pools with speculation and the mixed dispatch on,
              kernel path against plain; ``moe_mlp`` on the card against
              the CPU (routing equal, outputs within ``MOE_TOL``, a
              forced-drop case) with the smallest router margin; int8
              weights leaving the router and the experts f32 while the
              attention projections and the head launch ``w8a16_gemm``;
              ``parity_block``: starcoder2-3b's widths (LayerNorm, biases,
              the plain MLP), 2 layers, f32, biases and norm biases drawn
              non-zero: the dense forward on the card against the CPU,
              and the windowed config refused on the card (A.12);
  8a. retrieval_ivf  the port's ``retrieval/bench_ivf`` at its defaults
              (1,000,000 x 384 clustered rows, nlist 1,024, nprobe 32):
              exact and IVF ms a query, recall@10, build and ingest s,
              each store's device bytes;
  8b. serve_gemma  gemma-7b at full width and depth (28 layers, 8.5 B
              parameters, bf16, seeded) behind the HTTP server with the
              reference's defaults: ``serve``'s traffic, then one
              ``response_format: json_object`` request whose reply must
              parse; the attention kernels at head_dim 256, the grammar
              mask and the sampler at V = 256,000 launched;
  8c. serve_moe  mixtral-8x7b at full width, 8 of its 32 layers (23.7 GB
              of bf16 weights, seeded), behind the HTTP server with the
              reference's defaults: ``serve``'s traffic (256 tokens a
              decoder), every request 200,
              ``flash_prefill``, ``ragged_paged_attention`` and
              ``sample_slots`` launched; then one profiled decode step
              (``profile_moe``): the MoE's device ms by stage against
              every expert's bytes over 3.35 TB/s;
  9. serve    llama3-8b at full width and depth, bf16, random seeded
              weights, behind the port's HTTP server with the reference's
              defaults (``warmup`` first): 4 requests (10 chunks) admitted
              together, a ramp that holds decode, then 2 prompts of 1,296
              bytes once the first decode dispatch ran (mixed
              dispatches); proof that prefill, widened decode steps, mixed
              dispatches and sampled draws ran through the kernels, that
              the ramp held and that the narrow width rung ran (and how
              many dispatches were issued with another in flight); then
              a W = 5
              decode profile (``profile_wide``) and a mixed dispatch
              beside the two-dispatch pair doing the same work
              (``profile_mixed``);
 10. serve_int8  the same over an int8 KV pool (the int8 instance), without
              the two profiles (cut to keep the smoke's time);
 10c. serve_disagg  (after serve_multi) llama3-8b at full width and depth,
              bf16, workers behind the stdlib server sharing the weights,
              each with its own pool of 8 x 2,048, rows independent of
              timing: ``serve``'s traffic (96 tokens) and a json_object
              chat unified on a ``role=decode`` worker, then through a
              ``role=prefill`` worker's ``/v1/kv/prefill`` (frames) and the
              decode worker's ``/v1/kv/handoff``, streams equal, the
              prefill worker with no decode dispatch and no
              ``ragged_paged_attention`` launch, the decode worker with no
              ``flash_prefill`` launch for them (and over an int8 pool); a
              seeded stream pulled through ``GET /v1/kv/evacuation/<rid>``
              (per-step, and with ``decode_multistep=8`` blocks in flight)
              and resumed on a peer, equal; the decoders into 36 pages
              with the spill pool armed: a spill resume, no prefill for the
              promoted job, equal streams; each request's frame bytes and
              export, encode, decode and import ms, the longest prompt's
              gather and scatter against 3.35 TB/s and its TTFT through the
              handoff against unified;
 10d. serve_rag  (after serve_disagg) the north star's path: the
              repository's ``docs/*.md`` and ``SURVEY.md`` split 510 / 200,
              embedded by the Embedder at full e5-base in bf16 with its
              micro-batcher on, held in the VectorStore; 4 queries each
              embedded, searched at 40, reranked to 4 (full e5-base with
              the rank head, bf16), the passages in a chat to full
              llama3-8b behind the HTTP server; then 24 concurrent
              ``/v1/embeddings`` POSTs to an EncoderServer, fewer embed
              dispatches than requests; docs/s, pairs/s, embed, search
              and rerank ms a call, query-to-first-token s, peak memory;
 10e. serve_chain_server  (after serve_rag) the same path behind the
              port's chain server (``multi_turn_rag`` over full llama3-8b
              and full e5-base, bf16, micro-batchers on), driven over HTTP
              with the standard library: the corpus uploaded as multipart
              and listed, ``/search`` and greedy ``/generate`` (32 tokens,
              knowledge base on) for each query, a follow-up turn with
              history (the condense step and lookahead retrieval), one
              request without the knowledge base, 8 concurrent requests,
              a delete; every status and SSE frame as the reference
              gives them, each prompt holding its top reranked passage,
              each answer equal to the engine's direct greedy stream of
              the same prompt ids (the 8 concurrent ones: or parting at a
              tie of two bf16 ulps), their 8 query embeddings in fewer
              dispatches than requests, the three serving kernels
              launched; upload
              docs/s, the chain's stage histograms, request to first SSE
              chunk, e2e TTFT and latency;
 10f. serve_agents  (after serve_chain_server, on its engine core,
              tokenizer and encoders) the agentic chains, fired together
              so the engine batches them: ``agentic_rag``, ``router_rag``,
              ``query_decomposition_rag`` and ``text_to_sql`` each behind a
              ChainServer of its own (two of the corpus's files uploaded;
              for text_to_sql a note on the tables of a 3-table sqlite file
              whose schema and one question it trained on; then one greedy
              ``/generate`` of 32 tokens;
              ``/search`` for agentic_rag), a retriever of 2; beside them
              one ``ToolAgent`` episode forced to its approval-gated tool
              under the tool grammar (approved once, then denied), one
              ``StructuredExtractor.extract`` and one two-turn
              ``BashAgent.run`` whose policy approves only ``ls`` and
              ``pwd``, both replying under their reply format's grammar;
              every status 200, every SSE frame as the reference gives
              it, each answer the engine's stream or its chain's
              documented fallback, every tool call valid under its tool's
              schema, a record extracted, each bash turn an approved
              command that ran in its folder, the sqlite
              authorizer refusing a write, and ``flash_prefill``,
              ``ragged_paged_attention``, ``sample_slots`` and
              ``grammar_mask`` launched; per chain its engine requests,
              tokens and seconds, the agentic loop's grades, rewrites and
              attempts, the lookahead counters, ``grammar_attached``;
 10g. serve_qos  (after serve_events, on serve_chain_server's engine core)
              the QoS admission plane and the forensics plane over the
              engine server: ``APP_QOS=fair`` with tenants gold and bulk
              weighted 4:1, ``APP_FORENSICS=on``; bulk's 12 greedy chats,
              then gold's 4 and a best_effort chat with a 1 ms deadline;
              a forced page exhaustion (the chaos plane) once both
              tenants hold slots: the doomed chat shed before prefill,
              gold's chats admitted before bulk's backlog drains as the
              virtual times predict, a bulk victim, every stream equal to
              its replay with the plane off (or parting at a tie of two
              bf16 ulps), the debug routes, ``alerts_active`` and a
              flight dump's ``qos``; ``--serve-qos`` runs it alone;
 10b. serve_multi  llama3-8b over the smoke's BPE tokenizer, speculation
              off, K = 2: ``serve``'s traffic plus one request with a stop
              string, in a fixed order, with ``decode_multistep`` 0 and
              then 8: every request 200, equal streams, host fetches per
              token down at least 4x, the ragged kernel and
              ``sample_slots`` launched inside multi-step dispatches; a
              short run with ``decode_steps_max=32`` must deepen a
              dispatch; then ``profile_multi``, the device operations a
              step that the stop ring and the suspect lookup add;
 11. serve_prefix  the prefix cache behind the server: 12 chat requests
              over one 1,536-byte context, the first alone, 7 once its
              first token is out (cache hits arriving in a ramp), 4 after
              all finish (hits in a grouped prefill); every request's hit
              tokens equal ``_cap_shared``'s;
 12. serve_prefix_int8  the same over an int8 KV pool; both report the
              first tokens streamed between a dispatch's steps
              (``first_mid_dispatch``) and the cold TTFT;
 12b. serve_chain  ``serve``'s traffic (6 chat requests, 64 tokens) at the
              chain server's temperature 0.2 / top-p 0.7, seeds 0 to 5:
              every request answers 200 and ``sample_slots`` launches once
              per sampling call of the engine; then ``profile_sampled``:
              a decode dispatch at those settings beside the same one
              greedy at W = 5 (device operations, host wall and busy
              share a step);
 12c. serve_tools  llama3-8b over the smoke's BPE tokenizer on 12
              slots: two ``json_schema`` requests (one streamed), a forced
              tool call, a ``tool_choice: "auto"`` one, ``logprobs`` with
              ``top_logprobs: 5``, ``n = 2`` seeded and two plain ones, at
              once; every constrained reply validates, every logprob list
              has an entry a token, ``grammar_mask`` and the sampler's
              mask, advance and top variants launch; then the same
              traffic on the same core with the plain sampler and mask on
              the card (neither kernel launches): every token stream
              equal, and the logprob request's ``logprob_data`` (token and
              top ids exact, logprobs within 1e-5);
 13. serve_two_dispatch  the narrow path, bf16: 6 concurrent requests, then a
              narrow decode profile and a grouped-prefill profile (the
              int8 pool's two profiles and the Scheduler's decode at
              ``pipeline_depth`` 1 against 2 were cut for the smoke's
              time);
 14. dense    the dense-cache API on the same weights: prefill of 8 rows
              and 32 greedy decode steps through flash_prefill and
              ragged_decode;
 14a. serve_lora  ``serve``'s traffic with three adapters registered
              before ``warmup`` (rank 16, alpha 32, all seven targets,
              seeded): the requests name the base model and each adapter
              in turn, every reply echoes its id, no mixed dispatch runs,
              ``lora`` launches 4 x 32 times a forward pass with an
              adapter row (none in another); then
              ``/v1/models`` lists the adapters, an unknown id gets a
              404, and one prompt under each model shows each adapter's
              tokens differ from the base model's and no page is shared
              across adapters, while a second run under one is; then
              ``profile_lora``: ``profile_wide``'s W = 5 decode step with
              the base model and the three adapters in turn over the
              slots (``lora``'s device ms a step among the classes);
              then ``serve_lora_base``: the same adapters resident and
              the same traffic, every request naming the base model: no
              ``lora`` launch;
 14b. serve_ckpt  the same weights written as an HF checkpoint under
              build/ (``config.json``, four safetensors shards and their
              index, 16.06 GB) with a Llama-3-shaped ``tokenizer.json``
              made from seed 0 (128,000 entries, 256 specials,
              ``ignore_merges``), loaded by ``load_hf_dir`` bit-equal to
              the in-memory weights (load s, GB/s, peak GB), served behind
              the HTTP server with ``get_tokenizer(dir)``: four unicode
              chat requests greedy, one after another, then the same four
              at the chain server's settings at once; every
              ``prompt_tokens`` the chat template's length, every text
              ``decode`` of its ids, the greedy ids those of a Scheduler
              over the in-memory weights, through flash_prefill,
              ragged_paged_attention and sample_slots; the native
              tokenizer's host tokens/s over a 100 KB document and us a
              chat template;
 14c. serve_ckpt_w8  the directory loaded with ``quant="int8"``: every q
              and s bit-equal to ``quantize`` of the in-memory matrix, the
              load's peak within the int8 set plus two of its largest
              bf16 matrices; two chats through ``w8a16_gemm``; the
              directory is then removed (its run of ``serve``'s traffic,
              ``serve_ckpt_w8_traffic``, was cut to keep the smoke's
              time: it repeated ``serve_w8``'s dispatches and launches);
 15. serve_w8  ``serve`` with int8 weights (the bf16 set quantized in
              place): 7 ``w8a16_gemm`` launches a layer and one a head per
              forward pass, no ``F.linear``, and the launches by rows
              (``gemm_launches_by_rows``); then ``profile_w8``, a narrow
              decode step's GEMM device ms against the bytes it must read
              and the bf16 step's matmul ms;
 16. serve_70b_w8  after the llama3-8b weights are dropped: llama3-70b at
              full width and depth, int8 weights drawn from seed 0 and
              quantized as drawn, an int8 KV pool, the engine's defaults;
              ``serve``'s 4 decoders at 32 tokens, then one 1,296-byte
              prompt that rides mixed dispatches of 128 query vectors a
              row (query tiles of the ragged kernel); peak GB, warmup
              seconds, tok/s, TTFT and the GEMM's launches by rows.

Every phase also prints its wall seconds on a line of its own
(``phase_s``). Each serve phase reports the dispatch loop: dispatches per width rung,
held ticks, dispatches issued with another in flight and the most left in
flight, the warmup's seconds, the sampler's launches (equal to the
engine's sampling calls) and ``first_mid_dispatch``.

The flash phase runs 4 ragged chunks, the serve path's group of 8 chunks
(``prefill_group8``) and 8 cache-hit suffixes (``prefix_suffix``: 40 to
200 queries padded to 256 at starts 1,408 to 1,664), then at gemma-7b's
heads of 256 four full chunks and the group of 8; the ragged phases
run decode rows at batch 8 and at batch 1, Qb = 8 mixed rows, the verify
steps of widths 5 and 9 at batch 8 and the mixed program's rows
(``mixed_qb16``: 8 decode rows and 4 chunks of 512 at starts 0 to 1,536
in rows of 16 queries; ``mixed_prefix``: the same decode rows and 4
cache-hit suffixes of 64 to 200 tokens at starts 1,152 to 1,408, padded
to 512), and decode, verify 5 and 9 and mixed rows of 16 at gemma-7b's
heads (G = 1) and gemma-2b's (G = 8, query tiles of 4);
``ragged_decode`` batch 8 and batch 1 at llama3-8b's and gemma-7b's
heads, each with its split plan and scratch bytes. Each kernel phase
holds the
kernel to its plain version per (query, head) within one bf16 ulp of the
largest plain output (``compare``); kernel and library times are device
times of CUDA-graph replays (``graph_ms``), plain times of CUDA events
around eager calls. ``--planted-faults`` shows that this check fails a
dropped KV tile and a causal mask off by one in ``flash_prefill``, a
dropped tile, a dropped split in the combine, a causal limit off by one
and a wrong int8 scale slot in the decode-side walk, and a wrong
threefry rotation constant, a counter off by one, a strict top-p
predicate and z summed over every entry in the sampler, and a dropped
scale, a skipped contraction step (each instance) and a rank dropped
from the cluster's reduction in the W8A16 GEMM, a flipped bit, a dropped
row of an interleaved group, the fail-safe ignored and flags left set
in the grammar mask, a DFA advance short of the token's last byte, a
top-row tie taken by the higher index and the mask applied to an
unconstrained row in the sampler, and a wrong slot, base rows written,
a split's partial dropped from the reduction and a target's update
written into the next target's output in the LoRA update (these four
also run ``parity_lora``, which each must fail) and a dropped rank in
its bf16 shrink, and at head_dim 256 and V = 256,000: Q's A fragment of
the wrong k-step and Q staged in the ring in ``flash_prefill``, the f32
walk's splits starting at their 64-token index counted in 32-token steps
(overlapping splits; ``parity_gemma`` must fail), a token group's
partial merged into the wrong row, and z summed over every entry where
the sampler recomputes e (V = 256,000), each
planted in a temporary copy of the port, case by case: every case fails
under at least one fault;
``--ab`` times every attention kernel and the sampling call of two trees
of the port in turns, with the grouped-prefill profile and
``profile_sampled``, and every W8A16 GEMM case (device ms and host us a
call) with ``profile_w8`` (the parts named after the trees, all by
default); ``--lora-variants`` times a few LoRA cases, with each call's
shrink and expand device time, for the tree as it is and for each of
``LORA_VARIANTS`` (the design choices of ``csrc/lora.cu`` undone, one at
a time, in a temporary copy). ``--planted-faults
multi_running_dropped`` drops the multi-step decode's running mask in
``engine/engine.py`` (a suspect token no longer pauses its slot): the
streams stay equal and ``parity_multi``'s pause check must fail;
``import_pages_swapped`` (an import that swaps a slot's first two pages,
``engine/kv_cache.py``) and ``evac_position_dropped`` (a snapshot that
drops the seed's position, ``engine/scheduler.py``) must fail
``parity_disagg``; ``encoder_mask_last_token_dropped`` (the embedder's
mask drops each text's last token), ``reranker_separator_typed_passage``
(the separator typed as passage) and ``ivf_valid_mask_dropped`` (the IVF
search scores deleted rows) must fail ``parity_encoders``. Each main
path (8b to 16) sets the launch counts to 0 just before it and reads
them just after; every kernel must have launched on its path. Then
a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package. Exits non-zero without CUDA, or when the port is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 keeps 8 significant bits, so ulp(x) <= 2**-7 |x|. A kernel and its
# plain version each round one f32 result to bf16 (their f32 results differ
# by summation order, ~1e-6 relative), so a sound kernel differs from its
# plain version by at most one ulp of each output: for each (query, head)
# the limit is 2**-7 of its largest plain output.
BF16_ULP = 2.0 ** -7
TOLERANCE = "per (query, head): 2**-7 x its largest plain output (one bf16 ulp)"
PARITY_GAP_TOL = 1e-3    # a divergence is accepted only at a near-tie
# the kernel cases stop after their check (no timing): set by the planted
# faults' runs
CHECK_ONLY = False


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a line of its own with the phase's
    wall seconds (``phase_s``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    emit(name, phase_s=time.perf_counter() - t0)
    return out


def time_ms(fn, target_ms: float = 300.0) -> float:
    """Mean device time of ``fn()`` over many launches (CUDA events),
    after warm-up. Where one call's device time is shorter than the host's
    time to issue it, this reads the host: use ``graph_ms``."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = int(min(200, max(5, target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, target_ms: float = 300.0, per_graph: int = 32) -> float:
    """Mean device time of one ``fn()``: ``per_graph`` calls captured in a
    CUDA graph (each may take other inputs, as the layer walks do), the
    graph replayed many times between CUDA events, after warm-up. The host
    issues one replay per ``per_graph`` calls, so a call shorter than its
    own Python and launch overhead is still timed on the device; the time
    includes the gaps between consecutive kernels inside the graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    n = int(min(100, max(3, target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * per_graph)
    del graph
    return ms


class KernelMismatch(AssertionError):
    """A kernel disagreed with its plain version; ``reading`` holds the
    numbers."""

    def __init__(self, name: str, reading: dict):
        super().__init__(f"{name} disagrees with its plain version: "
                         f"{json.dumps(reading)}")
        self.reading = reading


def compare(name, got, want, valid):
    """Kernel output ``got`` against its plain version ``want``, both
    (rows, queries, H, HD), over the (rows, queries) marked ``valid``: every
    value finite, and each (query, head) within one bf16 ulp of its largest
    plain output (``BF16_ULP``). Returns the max abs error and the largest
    ratio of a (query, head)'s error to its limit; raises KernelMismatch."""
    import torch
    HD = got.shape[-1]
    sel = valid[..., None].expand(got.shape[:3]).reshape(-1)
    g = got.float().reshape(-1, HD)[sel]
    w = want.float().reshape(-1, HD)[sel]
    err = (g - w).abs().amax(dim=1)
    limit = BF16_ULP * w.abs().amax(dim=1)
    ratio = torch.where(err > 0, err / limit, torch.zeros_like(err))
    reading = {"max_abs_err": err.max().item(),
               "max_err_over_limit": ratio.max().item(),
               "finite": bool(torch.isfinite(got).all())}
    if not reading["finite"] or reading["max_err_over_limit"] > 1.0:
        raise KernelMismatch(name, reading)
    return reading


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build(gemm_report=True):
    """Build every kernel library; report each kernel instance's registers
    and spill bytes from the ``-Xptxas -v`` log and (``gemm_report``) the
    W8A16 GEMM's SASS counts and cluster occupancy."""
    import re
    from generativeaiexamples_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    per_lib = build.build_all()
    report = {}
    for name in build.KERNEL_SOURCES:
        entries, fn = [], None
        with open(build.lib_path(name) + ".log") as fh:
            for ln in fh:
                m = re.search(r"Compiling entry function '(\w+)'", ln)
                if m:
                    fn = m.group(1)
                m = re.search(r"(\d+) bytes spill stores", ln)
                if m and fn:
                    spill = int(m.group(1))
                m = re.search(r"Used (\d+) registers", ln)
                if m and fn:
                    entries.append({"fn": fn, "regs": int(m.group(1)),
                                    "spill_store_bytes": spill})
                    fn = None
        report[name] = entries
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_library_s={k: round(v, 3) for k, v in per_lib.items()},
         ptxas=report,
         **(dict(w8a16_gemm_sass=gemm_sass_counts(),
                 w8a16_gemm_max_clusters=gemm_max_clusters())
            if gemm_report else {}))


def gemm_sass_counts():
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in each W8A16
    GEMM kernel's SASS (``cuobjdump -sass``); every bf16 instance must
    hold both."""
    import re
    from generativeaiexamples_tpu_torch.ops.cuda import build
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(
        build._nvcc())), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.lib_path("w8a16_gemm")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", ln))
    bf16 = {f: c for f, c in counts.items() if "wgmma" in f}
    if not bf16 or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                       for c in bf16.values()):
        raise AssertionError(f"a bf16 W8A16 GEMM kernel lacks HGMMA or "
                             f"UTMALDG: {counts}")
    return counts


def gemm_max_clusters():
    """Clusters of 1, 2, 4 and 8 CTAs of the W8A16 GEMM that the card runs
    at once (``cudaOccupancyMaxActiveClusters``): the plan's slots."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    return cq._card(torch.cuda.current_device())[1]


# (H, KV, HD) of the attention cases: llama3-8b's heads, and the Gemma
# family's heads of 256: gemma-7b's 16 / 16 (G = 1) and gemma-2b's 8 / 1
# (G = 8)
LLAMA3_8B_HEADS = (32, 8, 128)
GEMMA_7B_HEADS = (16, 16, 256)
GEMMA_2B_HEADS = (8, 1, 256)


def _flash_case(dev, starts, lens, seed, C=512, heads=LLAMA3_8B_HEADS):
    """flash_prefill at ``heads`` (llama3-8b's by default) over G =
    len(starts) chunks of C queries against a T = 2048 dense view,
    bf16."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    (H, KV, HD), G, T = heads, len(starts), 2048
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((G, C, H, HD), generator=g, device=dev).to(bf)
    kk = torch.randn((G, T, KV, HD), generator=g, device=dev).to(bf)
    vv = torch.randn((G, T, KV, HD), generator=g, device=dev).to(bf)
    sp = torch.tensor(starts, dtype=torch.int32, device=dev)
    vt = torch.tensor([s + n for s, n in zip(starts, lens)],
                      dtype=torch.int32, device=dev)
    out = k.flash_prefill(q, kk, vv, sp, vt)
    ref = k.flash_prefill_plain(q, kk, vv, sp, vt)
    valid = torch.arange(C, device=dev)[None] < (vt - sp)[:, None]
    check = compare("flash_prefill", out, ref, valid)
    if CHECK_ONLY:
        return check
    # library yardstick: SDPA over K/V expanded to H heads, same mask
    qpos = sp[:, None].long() + torch.arange(C, device=dev)[None]
    kpos = torch.arange(T, device=dev)[None, None]
    mask = ((kpos <= qpos[:, :, None]) & (kpos < vt[:, None, None].long()))
    q_s = q.transpose(1, 2)
    k_s = kk.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    v_s = vv.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    m4 = mask[:, None]
    pairs = sum(min(s + i + 1, s + n) for s, n in zip(starts, lens)
                for i in range(n))
    flops = 4.0 * HD * H * pairs
    nbytes = 2.0 * (2 * sum(lens) * H * HD + 2 * sum(
        s + n for s, n in zip(starts, lens)) * KV * HD)
    b_ms, b_by = bound(flops, nbytes)
    ms = graph_ms(lambda: k.flash_prefill(q, kk, vv, sp, vt))
    return dict(
        **check, tolerance=TOLERANCE, ms=ms, share_of_bound=b_ms / ms,
        plain_ms=time_ms(lambda: k.flash_prefill_plain(q, kk, vv, sp, vt)),
        library_ms=graph_ms(lambda: sdpa(q_s, k_s, v_s, attn_mask=m4)),
        library_call="scaled_dot_product_attention (K/V pre-expanded to H "
                     "heads, boolean causal+length mask)",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        shape=dict(G=G, C=C, T=T, H=H, KV=KV, HD=HD, start_pos=starts,
                   chunk_len=lens, dtype="bfloat16"))


# a grouped prefill of 8 cache-hit suffixes: (page-aligned starts, live
# queries), padded to two pages of 128
PREFIX_SUFFIX = ([1408, 1536, 1664, 1408, 1536, 1664, 1408, 1536],
                 [40, 64, 100, 128, 150, 180, 200, 77])


GROUP8 = ([0, 512, 1024, 1536, 0, 0, 0, 0],
          [512, 512, 512, 512, 144, 300, 97, 450])


def flash_cases(dev):
    """The flash_prefill cases, each a thunk: four ragged chunks (row 1 a
    prompt's second chunk), the serve path's full group of 8 chunks
    (``prefill_group8``: a prompt's second to fourth chunks beside four
    first chunks), and 8 cache-hit suffixes (``prefix_suffix``); then the
    head_dim 256 instance at gemma-7b's heads: four full chunks of 512 of
    one prompt and a fresh one (``gemma7b_chunks4``) and the group of 8."""
    g7 = dict(heads=GEMMA_7B_HEADS)
    return {
        "chunks4": lambda: _flash_case(dev, [0, 512, 0, 0],
                                       [512, 300, 450, 97], 1),
        "prefill_group8": lambda: _flash_case(dev, *GROUP8, 6),
        "prefix_suffix": lambda: _flash_case(dev, *PREFIX_SUFFIX, 7, C=256),
        "gemma7b_chunks4": lambda: _flash_case(
            dev, [0, 512, 1024, 0], [512, 512, 512, 512], 8, **g7),
        "gemma7b_prefill_group8": lambda: _flash_case(dev, *GROUP8, 9, **g7),
    }


def _run_cases(name, cases):
    """The first case's numbers as the entry's own, the others as its
    sub-entries."""
    import torch
    first, *rest = cases
    res = dict(name=name, **cases[first]())
    for sub in rest:
        res[sub] = cases[sub]()
        torch.cuda.empty_cache()
    return res


def phase_flash(dev):
    res = _run_cases("flash_prefill", flash_cases(dev))
    emit("kernel:flash_prefill", kernel_ms=res["ms"], **res)
    return res


def _ragged_case(dev, R, Qb, lens, q_num, tag, quant=False, pos0=None,
                 slot_of_row=None, seed=None, H=32, KV=8, HD=128, L=32):
    """One shape of the ragged kernel over an L-layer pool of llama3-8b
    heads (H = 64: llama3-70b's, G = 8; or the Gemma family's heads of
    256): bf16 pages, or int8 pages with f32 (N, KV, page) scales. Row r
    reads the page-table row of slot ``slot_of_row[r]`` (default: a slot
    of its own), with its queries at ``pos0[r]`` on (default: its last
    ``q_num`` positions)."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    ps, maxp = 128, 16
    slot_of_row = list(range(R)) if slot_of_row is None else slot_of_row
    n_slots = max(slot_of_row) + 1
    P = max(8, n_slots) * maxp + 1
    g = torch.Generator(device=dev).manual_seed(
        2 + R + 100 * quant if seed is None else seed)
    bf = torch.bfloat16
    shape = (L * P, ps, KV * HD)
    if quant:
        k_pool, v_pool = (torch.randint(-127, 128, shape, generator=g,
                                        device=dev, dtype=torch.int8)
                          for _ in range(2))
        k_sc, v_sc = (torch.rand((L * P, KV, ps), generator=g, device=dev)
                      * 0.01 + 0.01 for _ in range(2))
    else:
        k_pool = torch.randn(shape, generator=g, device=dev).to(bf)
        v_pool = torch.randn(shape, generator=g, device=dev).to(bf)
        k_sc = v_sc = None
    q = torch.randn((R, Qb, H, HD), generator=g, device=dev).to(bf)
    perm = torch.randperm(P - 1, generator=g, device=dev)[:n_slots * maxp] + 1
    slot_tables = perm.reshape(n_slots, maxp).to(torch.int32)
    tables = slot_tables[torch.tensor(slot_of_row, device=dev)].contiguous()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    qn = torch.tensor(q_num, dtype=torch.int32, device=dev)
    pos0 = (kv_lens - qn if pos0 is None
            else torch.tensor(pos0, dtype=torch.int32, device=dev))
    layers = [torch.full((1,), i, dtype=torch.int32, device=dev)
              for i in range(L)]
    out = k.ragged_paged_attention(q, k_pool, v_pool, tables, kv_lens, pos0,
                                   qn, layer=layers[3], pages_per_layer=P,
                                   k_scales=k_sc, v_scales=v_sc)
    ref = k.ragged_paged_attention_plain(q, k_pool, v_pool, tables, kv_lens,
                                         pos0, qn, 3, P, k_sc, v_sc)
    valid = torch.arange(Qb, device=dev)[None] < qn[:, None]
    check = compare(f"ragged_paged_attention ({tag})", out, ref, valid)
    if not (out[qn == 0] == 0).all():
        raise AssertionError(f"ragged_paged_attention ({tag}): a q_num == 0 "
                             f"row is not zero")
    if CHECK_ONLY:
        return check
    it = iter(range(1 << 30))

    def run_kernel():
        # walk the layers so each launch reads pages cold from HBM
        layer = layers[next(it) % L]
        k.ragged_paged_attention(q, k_pool, v_pool, tables, kv_lens, pos0,
                                 qn, layer=layer, pages_per_layer=P,
                                 k_scales=k_sc, v_scales=v_sc)

    # library yardstick: SDPA over the rows' pages pre-gathered dense (and
    # pre-dequantized for the int8 pool), K/V expanded to H heads
    T = maxp * ps
    rows = 3 * P + tables.long()

    def dense(pool, sc):
        x = pool[rows].reshape(R, maxp, ps, KV, HD)
        if sc is not None:
            x = (x.float() * sc[rows].permute(0, 1, 3, 2)[..., None]).to(bf)
        return (x.reshape(R, T, KV, HD).repeat_interleave(H // KV, dim=2)
                .transpose(1, 2))

    k_d, v_d = dense(k_pool, k_sc), dense(v_pool, v_sc)
    qi = torch.arange(Qb, device=dev)
    t = torch.arange(T, device=dev)
    mask = ((t[None, None] <= (pos0[:, None] + qi[None])[:, :, None].long())
            & (t[None, None] < kv_lens[:, None, None].long()))[:, None]
    q_s = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    valid_q = sum(q_num)
    flops = 4.0 * HD * H * sum(
        max(0, min(p0 + j + 1, n))
        for p0, n, m in zip(pos0.tolist(), lens, q_num) for j in range(m))
    # each live token's K and V row once per slot, however many rows of the
    # slot read it (1 byte an element in int8, plus one f32 scale per KV
    # head each), q read and out written once in bf16
    live_by_slot = {}
    for slot, n, m in zip(slot_of_row, lens, q_num):
        if m:
            live_by_slot[slot] = max(live_by_slot.get(slot, 0), n)
    live = sum(live_by_slot.values())
    kv_bytes = live * KV * HD * 2 * (1 if quant else 2)
    scale_bytes = live * KV * 4 * 2 if quant else 0
    nbytes = float(kv_bytes + scale_bytes + 2 * valid_q * H * HD * 2)
    b_ms, b_by = bound(flops, nbytes)
    ms = graph_ms(run_kernel)
    # rows past the head dim's query vectors a block run as query tiles,
    # each a cell
    tq = _query_tile(k, Qb, H // KV, HD)
    res = dict(
        **check, tolerance=TOLERANCE, query_tiles=-(-Qb // tq),
        **_split_fields(dev, R * -(-Qb // tq), KV, T, tq * H // KV, HD),
        ms=ms, share_of_bound=b_ms / ms,
        plain_ms=time_ms(lambda: k.ragged_paged_attention_plain(
            q, k_pool, v_pool, tables, kv_lens, pos0, qn, 3, P, k_sc, v_sc)),
        library_ms=graph_ms(lambda: sdpa(q_s, k_d, v_d, attn_mask=mask)),
        library_call="scaled_dot_product_attention over the rows' pages "
                     "pre-gathered dense" + (" and pre-dequantized to bf16"
                                             if quant else "")
                     + " (gather not timed)",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        kv_bytes=kv_bytes, scale_bytes=scale_bytes, live_tokens=live,
        shape=dict(R=R, Qb=Qb, H=H, KV=KV, HD=HD, page=ps, maxp=maxp,
                   layer=3, n_layers=L, kv_lens=lens, q_num=q_num,
                   q_pos0=pos0.tolist(), slots=n_slots,
                   q_dtype="bfloat16", pool="int8" if quant else "bfloat16"))
    del k_pool, v_pool, k_d, v_d
    return res


DECODE_LENS = [1, 77, 300, 640, 1000, 1333, 1800, 2047]
BATCH1_LENS = [2047]


def _query_tile(k, Qb, G, HD):
    """The wrapper's query tile of a row (a tree from before query tiles:
    the whole row; before per-head-dim tiles: the 128 rule)."""
    if not hasattr(k, "query_tile"):
        return Qb
    return (k.query_tile(Qb, G, HD) if hasattr(k, "qg_max")
            else k.query_tile(Qb, G))


def _split_fields(dev, rows, kv_heads, capacity, qg, head_dim):
    """The decode-side kernels' split plan for one launch and its scratch
    (from shapes, as the wrapper computes them)."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    if not hasattr(k, "split_plan"):       # a tree from before the split
        return dict(splits=1, blocks=rows * kv_heads, scratch_bytes=0)
    plan = k.split_plan(rows, kv_heads, capacity,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    return dict(splits=plan.splits, tiles_per_split=plan.tiles,
                blocks=rows * kv_heads * plan.splits,
                scratch_bytes=plan.scratch_bytes(rows * kv_heads, qg,
                                                 head_dim))


def _verify_case(dev, W, quant, H=32, tag=None, **heads):
    """A W-wide speculative verify step at batch 8: the batch-8 decode
    rows' lengths (at least W), all W queries live."""
    lens = [max(n, W) for n in DECODE_LENS]
    tag = tag or f"verify_qb{W}" + ("" if H == 32 else "_g8")
    return _ragged_case(dev, 8, W, lens, [W] * 8, tag, quant,
                        seed=20 + W + 100 * quant + (H != 32) + len(heads),
                        H=H, **heads)


# the mixed program's rows at llama3-8b (q_block 16 for the top verify
# width 9): 8 decode rows of 9 live queries, then 4 chunks of 512 at
# starts 0/512/1,024/1,536, each 32 rows of 16 queries over its own slot
MIXED_STARTS = (0, 512, 1024, 1536)
# cache-hit suffixes riding a mixed dispatch, as the engine packs them:
# (start, live tokens) at page-aligned starts that are not multiples of
# 512, each padded to 512 (32 rows of 16 queries, the rows past the
# suffix idle with kv_len 0)
PREFIX_CHUNKS = ((1152, 64), (1280, 200), (1408, 120), (1152, 160))


def _mixed_case(dev, quant, chunks=None, tag="mixed_qb16", H=32, **heads):
    chunks = chunks or tuple((start, 512) for start in MIXED_STARTS)
    lens = [max(n, 9) for n in DECODE_LENS]
    q_num, pos0, slots = [9] * 8, [n - 9 for n in lens], list(range(8))
    for c, (start, n) in enumerate(chunks):
        for j in range(512 // 16):
            live = min(16, max(0, n - 16 * j))
            lens.append(start + n if live else 0)
            q_num.append(live)
            pos0.append(start + 16 * j)
            slots.append(8 + c)
    return _ragged_case(dev, len(lens), 16, lens, q_num, tag, quant,
                        pos0=pos0, slot_of_row=slots,
                        seed=40 + 100 * quant + (tag != "mixed_qb16"), H=H,
                        **heads)


RAGGED_SUBCASES = ("mixed_rows", "batch1", "verify_qb5", "verify_qb9",
                   "mixed_qb16", "mixed_prefix", "verify_qb9_g8",
                   "mixed_qb16_g8")
def _gemma_ragged_cases(dev, quant):
    """The Gemma family's cases: decode at batch 8, the verify steps of
    widths 5 and 9 and the mixed rows of 16, at gemma-7b's heads (G = 1)
    and at gemma-2b's (G = 8: rows of 40, 72 and 128 query vectors, past
    the 32 a block holds at head_dim 256, run as query tiles of 4), over
    8 layers of pool."""
    cases = {}
    for m, (H, KV, HD) in (("gemma7b", GEMMA_7B_HEADS),
                           ("gemma2b", GEMMA_2B_HEADS)):
        kw = dict(H=H, KV=KV, HD=HD, L=8)
        cases[f"{m}_decode"] = (lambda kw=kw, m=m: _ragged_case(
            dev, 8, 1, DECODE_LENS, [1] * 8, f"{m}_decode", quant,
            seed=3 + 100 * quant + H, **kw))
        for W in (5, 9):
            cases[f"{m}_verify_qb{W}"] = (
                lambda kw=kw, m=m, W=W: _verify_case(
                    dev, W, quant, tag=f"{m}_verify_qb{W}", **kw))
        cases[f"{m}_mixed_qb16"] = (lambda kw=kw, m=m: _mixed_case(
            dev, quant, tag=f"{m}_mixed_qb16", **kw))
    return cases


def ragged_cases(dev, quant=False):
    """The ragged kernel's cases, each a thunk: decode rows at batch 8 (the
    narrow serving shape), mixed rows (Qb = 8, q_num 8/3/1/0), one decode
    row at batch 1, the verify steps of widths 5 and 9 at batch 8, the
    mixed program's 136 rows, and the same with cache-hit suffixes for
    chunks (``mixed_prefix``); then llama3-70b's heads (G = 8) at the
    verify width 9 (72 query vectors a row) and the mixed rows of 16
    (128), each row two query tiles; then the Gemma family's heads of 256
    (``_gemma_ragged_cases``)."""
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    cases = {
        "decode": lambda: _ragged_case(dev, 8, 1, DECODE_LENS, [1] * 8,
                                       "decode", quant),
        "mixed_rows": lambda: _ragged_case(dev, 4, 8, [520, 1000, 64, 700],
                                           [8, 3, 1, 0], "mixed", quant),
        "batch1": lambda: _ragged_case(dev, 1, 1, BATCH1_LENS, [1], "batch1",
                                       quant),
        "verify_qb5": lambda: _verify_case(dev, 5, quant),
        "verify_qb9": lambda: _verify_case(dev, 9, quant),
        "mixed_qb16": lambda: _mixed_case(dev, quant),
        "mixed_prefix": lambda: _mixed_case(dev, quant, PREFIX_CHUNKS,
                                            "mixed_prefix"),
    }
    if hasattr(k, "query_tile"):     # a tree whose rows take query tiles
        cases["verify_qb9_g8"] = lambda: _verify_case(dev, 9, quant, H=64)
        cases["mixed_qb16_g8"] = lambda: _mixed_case(
            dev, quant, tag="mixed_qb16_g8", H=64)
    if 256 in k.HEAD_DIMS:            # a tree with the head_dim 256 walk
        cases.update(_gemma_ragged_cases(dev, quant))
    return cases


def phase_ragged(dev, quant=False):
    name = "ragged_paged_attention" + ("_int8" if quant else "")
    res = _run_cases(name, ragged_cases(dev, quant))
    emit("kernel:" + name, kernel_ms=res["ms"], **res)
    return res


def _decode_case(dev, lengths, seed, heads=LLAMA3_8B_HEADS, L=32):
    """ragged_decode at a decode layer of ``heads`` (llama3-8b's by
    default) over a dense (L, B, T, KV, HD) cache, T = 2048, one slot per
    length."""
    import torch
    from generativeaiexamples_tpu_torch.ops.attention import mha_decode
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    (H, KV, HD), B, T = heads, len(lengths), 2048
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    kc = torch.randn((L, B, T, KV, HD), generator=g, device=dev).to(bf)
    vc = torch.randn((L, B, T, KV, HD), generator=g, device=dev).to(bf)
    q = torch.randn((B, 1, H, HD), generator=g, device=dev).to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = k.ragged_decode(q, kc[3], vc[3], lens)
    ref = mha_decode(q, kc[3], vc[3], lens)
    check = compare("ragged_decode", out, ref,
                    torch.ones((B, 1), dtype=torch.bool, device=dev))
    if CHECK_ONLY:
        return check
    it = iter(range(1 << 30))

    def run_kernel():
        i = next(it) % L          # walk the layers: cold cache rows
        k.ragged_decode(q, kc[i], vc[i], lens)

    # library yardstick: SDPA with a length mask on the dense cache, K/V
    # expanded to H heads (expansion not timed)
    k_s = kc[3].repeat_interleave(H // KV, dim=2).transpose(1, 2)
    v_s = vc[3].repeat_interleave(H // KV, dim=2).transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None] < lens[:, None].long())[
        :, None, None]
    q_s = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = sum(lengths)
    flops = 4.0 * HD * H * live
    nbytes = 2.0 * (live * KV * HD * 2 + 2 * B * H * HD)
    b_ms, b_by = bound(flops, nbytes)
    ms = graph_ms(run_kernel)
    return dict(
        **check, tolerance=TOLERANCE,
        **_split_fields(dev, B, KV, T, H // KV, HD), ms=ms,
        share_of_bound=b_ms / ms,
        plain_ms=time_ms(lambda: mha_decode(q, kc[3], vc[3], lens)),
        library_ms=graph_ms(lambda: sdpa(q_s, k_s, v_s, attn_mask=mask)),
        library_call="scaled_dot_product_attention with a length mask on the "
                     "dense cache, K/V pre-expanded to H heads",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        live_tokens=live,
        shape=dict(B=B, T=T, H=H, KV=KV, HD=HD, n_layers=L,
                   lengths=lengths, dtype="bfloat16"))


def decode_cases(dev):
    """ragged_decode at batch 8 (the dense API's decode shape) and at
    batch 1, at llama3-8b's heads and at gemma-7b's (head_dim 256, 8
    layers of cache)."""
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    cases = {"decode": lambda: _decode_case(dev, DECODE_LENS, 4),
             "batch1": lambda: _decode_case(dev, BATCH1_LENS, 5)}
    if 256 in k.HEAD_DIMS:
        g7 = dict(heads=GEMMA_7B_HEADS, L=8)
        cases["gemma7b_decode"] = lambda: _decode_case(dev, DECODE_LENS, 14,
                                                       **g7)
        cases["gemma7b_batch1"] = lambda: _decode_case(dev, BATCH1_LENS, 15,
                                                       **g7)
    return cases


def phase_decode(dev):
    res = _run_cases("ragged_decode", decode_cases(dev))
    emit("kernel:ragged_decode", kernel_ms=res["ms"], **res)
    return res


# ---------------------------------------------------------------------------
# The W8A16 GEMM
# ---------------------------------------------------------------------------

# (name, N, K) of each weight shape a forward pass multiplies by: wq and wo
# (equal at both sizes), wk and wv, gate and up, down, lm_head
GEMM_SHAPES = {
    "8b": (("wq_wo", 4096, 4096), ("wk_wv", 1024, 4096),
           ("gate_up", 14336, 4096), ("down", 4096, 14336),
           ("lm_head", 128256, 4096)),
    "70b": (("wq_wo", 8192, 8192), ("wk_wv", 1024, 8192),
            ("gate_up", 28672, 8192), ("down", 8192, 28672),
            ("lm_head", 128256, 8192)),
}
# rows: a narrow decode step (8 slots), W = 5 and W = 9 verify steps, a
# grouped prefill of 8 chunks of 512; llama3-70b at the decode widths, its
# grouped prefill and the rows of the mixed dispatch that serve_70b_w8
# launches (its ``gemm_launches_by_rows``)
MIXED_70B_ROWS = 584       # 8 slots x W = 9, and one chunk of 512
GEMM_ROWS = {"8b": (8, 40, 72, 4096), "70b": (8, 72, 4096, MIXED_70B_ROWS)}
PEAK_F32_FLOPS = 67e12     # the H100 SXM's f32 rate outside the tensor cores
GEMM_TOLERANCE = ("per element: 2**-7 x (|plain product before the scale| "
                  "x s + |plain result|) (bf16: one ulp of each rounding; "
                  "f32: 2**-22) + 2**-16 x (|x| @ |q|^T) x s (summation "
                  "order)")


def gemm_inputs(dev, M, N, K, dtype, seed):
    """x (M, K) standard normal in ``dtype``, q (N, K) int8 uniform over
    -127..127, s (N,) f32 near what per-channel quantization of a
    fan-in-scaled normal weight gives (4.5 / sqrt(K) / 127)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    q = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=dev) + 0.5) * (
        4.5 / K ** 0.5 / 127)
    return x, q, s


def check_gemm(name, x, q, s, got):
    """The kernel's (M, N) ``got`` against the plain version on the same
    inputs, within ``GEMM_TOLERANCE``: every value finite and no element
    past its limit. Returns the max abs error and the largest ratio of an
    error to its limit; raises KernelMismatch."""
    import torch
    import torch.nn.functional as F
    dt = x.dtype
    unscaled = F.linear(x, q.to(dt))               # the plain's product
    sb = s.to(dt).float()
    want = (unscaled * s.to(dt)).float()           # w8a16_gemm_plain
    absdot = F.linear(x.float().abs(), q.float().abs()) * sb
    ulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
    limit = ulp * (unscaled.float().abs() * sb + want.abs()) \
        + 2.0 ** -16 * absdot
    err = (got.float() - want).abs()
    reading = {"max_abs_err": err.max().item(),
               "max_err_over_limit": (err / limit).max().item(),
               "finite": bool(torch.isfinite(got).all())}
    del unscaled, absdot, limit, err, want
    if not reading["finite"] or reading["max_err_over_limit"] > 1.0:
        raise KernelMismatch(name, reading)
    return reading


def host_us(fn, calls):
    """Host microseconds a call of ``fn`` (eager, no synchronise inside:
    what issuing it costs the host), after warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def _gemm_timing(M, N, K, x, q, s):
    """w8a16_gemm's device ms over enough copies of the weight to pass L2
    (decode finds every weight cold) and its host us a call, through the
    wrapper's public call only (``--ab`` runs this against older trees),
    and the weight copies."""
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    copies = max(1, min(32, -(-(256 << 20) // (N * K))))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    it = iter(range(1 << 30))
    ms = graph_ms(lambda: cq.w8a16_gemm(x, qs[next(it) % copies], s),
                  target_ms=150.0, per_graph=8)
    us = host_us(lambda: cq.w8a16_gemm(x, q, s), 100 if M <= 128 else 10)
    return ms, us, qs


def _gemm_case(dev, M, N, K, dtype, seed):
    """w8a16_gemm at one shape: checked against its plain version, then
    timed (``_gemm_timing``) beside the plain version (eager dequantize +
    F.linear) and the library yardstick (F.linear over the
    bf16-dequantized weight, dequantization not timed)."""
    import torch
    import torch.nn.functional as F
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    x, q, s = gemm_inputs(dev, M, N, K, dtype, seed)
    out = cq.w8a16_gemm(x, q, s)
    check = check_gemm("w8a16_gemm", x, q, s, out)
    if CHECK_ONLY:
        return check
    ms, us, qs = _gemm_timing(M, N, K, x, q, s)
    copies = len(qs)
    deq = [(w.float() * s[:, None]).to(x.dtype) for w in qs]
    it2 = iter(range(1 << 30))
    it3 = iter(range(1 << 30))
    size = x.element_size()
    flops = 2.0 * M * N * K
    nbytes = float(N * K + 4 * N + size * (M * K + M * N))
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    b_ms, b_by = bound(flops, nbytes, peak)
    plan = cq.card_plan(M, N, K, dev)
    res = dict(
        **check, tolerance=GEMM_TOLERANCE, ms=ms, share_of_bound=b_ms / ms,
        host_us=us,
        plain_ms=time_ms(lambda: cq.w8a16_gemm_plain(
            x, qs[next(it2) % copies], s), target_ms=150.0),
        library_ms=graph_ms(lambda: F.linear(x, deq[next(it3) % copies]),
                            target_ms=150.0, per_graph=8),
        library_call="F.linear over the weight dequantized to "
                     + str(x.dtype).removeprefix("torch.")
                     + " (dequantization not timed)",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        weight_copies=copies,
        plan=(None if x.dtype != torch.bfloat16 else
              dict(plan._asdict(), rows=plan.rows, instance=plan.instance,
                   ctas=plan.ctas)),
        shape=dict(M=M, N=N, K=K, dtype=str(x.dtype).removeprefix("torch.")))
    del qs, deq
    return res


def gemm_case_shapes():
    """tag -> (M, N, K, dtype name, seed) of every W8A16 GEMM case: every
    weight shape of llama3-8b at 8, 40, 72 and 4,096 rows and of llama3-70b
    at 8, 72, 4,096 and its mixed dispatch's rows, bf16; and wq at 8 rows
    in f32 (the parity phase's dtype). The first, gate/up at a narrow
    decode step, is the entry's own."""
    shapes = {}
    order = [("8b", "gate_up", 8)] + [
        (m, name, M) for m in ("8b", "70b") for name, _, _ in GEMM_SHAPES[m]
        for M in GEMM_ROWS[m]]
    for i, (m, name, M) in enumerate(order):
        tag = f"{m}_{name}_m{M}"
        if tag in shapes:
            continue
        N, K = next((n, k) for nm, n, k in GEMM_SHAPES[m] if nm == name)
        shapes[tag] = (M, N, K, "bfloat16", 90 + i)
    shapes["8b_wq_wo_m8_f32"] = (8, 4096, 4096, "float32", 89)
    return shapes


# the ring check: 8b gate/up at 72 rows, a decode ring of 7 stages (odd,
# so its slots pass between the two consumer warpgroups within a tile) and
# 32 stages a tile; the first stage's loads issued this long after the
# rest of the ring's first fill
GEMM_LATE_NS = 50_000


def _gemm_late_ring_case(dev):
    """The W8A16 GEMM's ring protocol under the late first stage
    (``late_first_ns=GEMM_LATE_NS``): each warpgroup reaches a slot's
    next fill while the other still waits for its first, so a wait that
    took the older, incomplete phase for the newer would read the slot
    before its data landed. The result must pass ``check_gemm`` and equal
    the undelayed launch's bit for bit. Check only: not timed."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq
    x, q, s = gemm_inputs(dev, 72, 14336, 4096, torch.bfloat16, 97)
    late = cq.w8a16_gemm(x, q, s, late_first_ns=GEMM_LATE_NS)
    res = check_gemm("w8a16_gemm", x, q, s, late)
    if not torch.equal(late, cq.w8a16_gemm(x, q, s)):
        raise KernelMismatch("w8a16_gemm", dict(
            res, bit_equal_to_undelayed=False))
    return dict(res, late_first_ns=GEMM_LATE_NS, bit_equal_to_undelayed=True)


def gemm_cases(dev):
    """The W8A16 GEMM's cases (``gemm_case_shapes``), each a thunk, and
    the ring check (``_gemm_late_ring_case``)."""
    import torch
    cases = {tag: (lambda M=M, N=N, K=K, dt=dt, seed=seed: _gemm_case(
        dev, M, N, K, getattr(torch, dt), seed))
        for tag, (M, N, K, dt, seed) in gemm_case_shapes().items()}
    cases["8b_gate_up_m72_late_ring"] = lambda: _gemm_late_ring_case(dev)
    return cases


def ab_gemm(dev):
    """Every GEMM case's device ms and host us a call through the tree's
    ``w8a16_gemm`` (``--ab``)."""
    import torch
    out = {}
    for tag, (M, N, K, dt, seed) in gemm_case_shapes().items():
        x, q, s = gemm_inputs(dev, M, N, K, getattr(torch, dt), seed)
        ms, us, qs = _gemm_timing(M, N, K, x, q, s)
        out[tag] = {"ms": ms, "host_us": us}
        del x, q, s, qs
        torch.cuda.empty_cache()
    return out


def phase_gemm(dev):
    res = _run_cases("w8a16_gemm", gemm_cases(dev))
    emit("kernel:w8a16_gemm", kernel_ms=res["ms"], **res)
    return res


# the sampler's cases: R = 8 slots (a narrow step), 40 (the W = 5 rung)
# and 72 (the top W = 9 rung) rows over llama3-8b's vocabulary
SAMPLE_ROWS = (72, 8, 40)
SAMPLE_VOCAB = 128_256
GEMMA_VOCAB = 256_000
SAMPLE_SLOTS = 8
# 32-bit operations a vocabulary entry costs the draw: threefry2x32's
# 2 initial key adds, 20 rounds of add, rotate (one funnel shift) and xor,
# 5 key injections of 3 adds; the xor of its words, the uniform's shift,
# or, subtract, scale, add and max; two logs and two negations; the add of
# the logit and the compare of the argmax
SAMPLE_OPS_PER_ENTRY = 2 + 20 * 3 + 5 * 3 + 1 + 6 + 4 + 2
# the passes over every entry of a row: the load pass (scale, max, min,
# argmax compare, and the logsumexp's exp and add), a top-k round
# (compare, add), the top-p mass's set-up (subtract, exp, select, add) and
# a top-p round (compare, select, add)
LOAD_OPS_PER_ENTRY = 6
K_ROUND_OPS_PER_ENTRY = 2
Z_OPS_PER_ENTRY = 4
P_ROUND_OPS_PER_ENTRY = 3
N_BISECT = 26
# the card's rate for 32-bit operations outside the tensor cores: the
# H100 SXM's float32 peak (67 TFLOP/s, an FMA counted as two), taken as a
# lower bound on time for 32-bit integer work too
PEAK_32BIT_OPS = 67e12
NEAR_TIE = 1e-5     # a row whose plain top two logit + gumbel lie closer
# a top-p cutoff may differ only where the plain mass at the higher of the
# two cutoffs lies within this share of z of the target: two float32 sums
# of up to 128,256 terms in other orders differ by less
CUTOFF_TIE = 1e-5
# each slot's (temperature, top_k, top_p): greedy, temperature 0.7,
# top-k 50, top-p 0.9, the chain server's 0.2 / 0.7, both filters at
# temperature 1, top-p 0 (greedy by the cut), top-k past the vocabulary
SAMPLE_SETTINGS = ((0.0, 0, 1.0), (0.7, 0, 1.0), (0.7, 50, 1.0),
                   (0.7, 0, 0.9), (0.2, 0, 0.7), (1.0, 50, 0.9),
                   (0.7, 0, 0.0), (0.7, SAMPLE_VOCAB + 5, 1.0))


def sampler_inputs(dev, B, W, V, dtype, seed):
    """One sampling call's arguments: (B * W, V) logits (N(0, 3) from a
    seed, in ``dtype``), slot b's settings ``SAMPLE_SETTINGS[(b + seed) %
    8]``, every fifth slot inactive, counters from the seed (past 2**31 for
    some slots), and degenerate rows: one of -inf entries, one spanning
    more than 100 nats, a sampled row of -inf only, and a greedy row whose
    maximum is a -0.0 / +0.0 pair (the first three sampled rows and the
    last greedy one)."""
    import torch
    from generativeaiexamples_tpu_torch.ops import threefry
    g = torch.Generator(device=dev).manual_seed(seed)
    R = B * W
    lf = torch.randn((R, V), generator=g, device=dev) * 3
    # top-k past the vocabulary at any V
    sets = [(t, V + 5 if k == SAMPLE_VOCAB + 5 else k, p)
            for t, k, p in (SAMPLE_SETTINGS[(b + seed) % 8]
                            for b in range(B))]
    temp = torch.tensor([x[0] for x in sets], device=dev)
    top_k = torch.tensor([x[1] for x in sets], dtype=torch.int32, device=dev)
    top_p = torch.tensor([x[2] for x in sets], device=dev)
    active = (torch.arange(B, device=dev) + seed) % 5 != 0
    counter0 = torch.randint(0, 2 ** 32, (B,), generator=g, device=dev)
    counter0 = torch.where(torch.arange(B, device=dev) % 2 == 0,
                           counter0 % 4096, counter0).to(torch.int64)
    keys = threefry.prng_key(torch.arange(B) + seed).to(dev)
    sampled = [r for r in range(R) if sets[r // W][0] > 0
               and bool(active[r // W])]
    greedy = [r for r in range(R) if r not in sampled]
    for i, r in enumerate(sampled[:3]):
        if i == 0:
            lf[r, : V // 3] = -torch.inf
        elif i == 1:
            lf[r, : V // 4] -= 130.0
        else:
            lf[r] = -torch.inf
    if greedy:
        r = greedy[-1]
        lf[r] = -lf[r].abs() - 1.0
        lf[r, 5], lf[r, 9] = -0.0, 0.0
    return (keys, counter0, W, lf.to(dtype), temp, top_k, top_p, active)


def _allowed_set(opts, V):
    """The (R, V) entries a masked call draws from: the bitmask's, and
    every entry of a row whose ``mask_states`` is <= 0 (its words are
    not read)."""
    from generativeaiexamples_tpu_torch.ops import sampling
    return (sampling.unpack_mask(opts["allowed"], V)
            | (opts["mask_states"] <= 0)[:, None])


def _sampler_plain(args, opts=None):
    """The plain version's view of one call: tokens, logprobs, cutoffs,
    each row's scaled row, live settings, folded key and masked row (the
    entries of ``_allowed_set`` only), and the options' outputs."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling, threefry
    keys, counter0, W, logits, temp, top_k, top_p, active = args
    R, V = logits.shape
    opts = opts or {}
    tok, lp, extra = sampling.sample_slots_plain(*args, **opts)
    drawn = logits.float()
    if opts.get("allowed") is not None:
        drawn = torch.where(_allowed_set(opts, V), drawn,
                            torch.full((), -torch.inf, device=drawn.device))
    cuts = sampling.sample_cutoffs_plain(W, drawn, temp, top_k, top_p,
                                         active)
    t, k, p = sampling._live_rows(W, temp, top_k, top_p, active)
    safe_t = torch.where(t > 0, t, torch.ones_like(t))[:, None]
    scaled = drawn / safe_t
    pos = torch.arange(W, dtype=torch.int64, device=keys.device)
    row_keys = threefry.fold_in(keys[:, None, :], counter0.to(torch.int64)
                                [:, None] + pos[None]).reshape(R, 2)
    masked = sampling._mask_dynamic(drawn, t, k, p)
    return dict(tok=tok, lp=lp, cuts=cuts, t=t, k=k, p=p, scaled=scaled,
                row_keys=row_keys, masked=masked, extra=extra)


def check_sampler(args, opts=None):
    """``sample_slots`` on the card against its plain version on the same
    inputs. Every sampled row's thr_k bit-equal; thr_p equal except at a
    cutoff near-tie (some entry lies between the two cutoffs and the plain
    mass at the higher one is positive and within ``CUTOFF_TIE`` x z of
    the target);
    tokens equal except at those rows and at draw near-ties (the plain top
    two masked logit + gumbel within ``NEAR_TIE``); logprobs within 1e-5
    of the plain formula at the kernel's token; the threefry bits of each
    row's key exact. With ``opts`` (``sample_slots``' options): the draw
    over the allowed entries only; each slot's advanced state equal to
    ``grammar_advance_plain`` of the kernel's own token at w = 0; the top
    ids equal to ``top_logprobs_plain``'s, ties included, and their
    logprobs within 1e-5. Returns the reading; raises KernelMismatch."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling, threefry
    from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
    opts = opts or {}
    logits = args[3]
    tok, lp, extra = ks.sample_slots(*args, **opts)
    tok_c, lp_c, cuts = ks.sample_cutoffs(*args, **opts)
    pl = _sampler_plain(args, opts)
    sampled = pl["t"] > 0
    bits = lambda x: x.contiguous().view(torch.int32)
    same = bits(cuts) == bits(pl["cuts"])
    scaled = pl["scaled"]
    m = scaled.amax(dim=1)
    # cutoff near-ties, row by row, in float64 on the plain side
    kmask = scaled >= pl["cuts"][:, 0:1]
    e = torch.exp((scaled - m[:, None]).double())
    e = torch.where(kmask, e, torch.zeros_like(e))
    z = e.sum(dim=1)
    target = pl["p"].clamp(0.0, 1.0).double() * z
    lo = torch.minimum(cuts[:, 1], pl["cuts"][:, 1])[:, None]
    hi = torch.maximum(cuts[:, 1], pl["cuts"][:, 1])[:, None]
    between = (kmask & (scaled >= lo) & (scaled < hi)).any(dim=1)
    mass_hi = torch.where(scaled >= hi, e, torch.zeros_like(e)).sum(dim=1)
    # an empty set above both cutoffs sums to 0 on both sides exactly, so
    # it is no tie
    cut_tie = (sampled & ~same[:, 1] & between & (mass_hi > 0)
               & ((mass_hi - target).abs() <= CUTOFF_TIE * z))
    thr_k_bad = sampled & ~same[:, 0]
    thr_p_bad = sampled & ~same[:, 1] & ~cut_tie
    g = threefry.gumbel(pl["row_keys"], logits.shape[1]) + pl["masked"]
    top2 = g.topk(2, dim=-1).values
    draw_tie = sampled & ((top2[:, 0] - top2[:, 1]) < NEAR_TIE)
    differ = tok != pl["tok"]
    lp_want = sampling.token_logprob(logits, tok)
    lp_err = torch.where(torch.isnan(lp_want) & torch.isnan(lp),
                         torch.zeros_like(lp), (lp - lp_want).abs())
    n = min(4099, logits.shape[1])
    bits_ok = bool(torch.equal(ks.threefry_bits(pl["row_keys"], n),
                               threefry.random_bits(pl["row_keys"], n)))
    reading = {
        "rows": logits.shape[0], "sampled_rows": int(sampled.sum()),
        "thr_k_mismatches": int(thr_k_bad.sum()),
        "thr_p_mismatches_off_near_ties": int(thr_p_bad.sum()),
        "cutoff_near_tie_rows": int(cut_tie.sum()),
        "draw_near_tie_rows": int(draw_tie.sum()),
        "token_mismatches": int(differ.sum()),
        "mismatches_off_near_ties": int((differ & ~cut_tie
                                         & ~draw_tie).sum()),
        "entries_equal": bool(torch.equal(tok, tok_c)
                              and torch.equal(bits(lp), bits(lp_c))),
        "max_abs_err": float(lp_err.max()), "bits_exact": bits_ok}
    bad = False
    if opts.get("allowed") is not None:
        allowed = _allowed_set(opts, logits.shape[1])
        # a row whose allowed entries are all -inf draws index 0, as the
        # reference's sampler does over an all -inf row
        live = pl["scaled"].amax(dim=1) > -torch.inf
        off = ~allowed.gather(1, tok.long()[:, None])[:, 0] & live
        reading["masked_rows"] = int((~allowed).any(dim=1).sum())
        reading["tokens_off_the_mask"] = int(off.sum())
        bad |= bool(off.any())
    if opts.get("grammar") is not None:
        state, table, tok_bytes, tok_lens = opts["grammar"]
        W, active = args[2], args[7]
        want = torch.where(active, sampling.grammar_advance_plain(
            state, tok.reshape(-1, W)[:, 0], table, tok_bytes, tok_lens),
            state)
        reading["advanced_slots"] = int(((state > 0) & active).sum())
        reading["advance_mismatches"] = int(
            (extra["next_state"] != want).sum())
        bad |= reading["advance_mismatches"] > 0
    if opts.get("want_top"):
        ids, lps = sampling.top_logprobs_plain(logits)
        both_nan = torch.isnan(lps) & torch.isnan(extra["top_lps"])
        err = torch.where(both_nan, torch.zeros_like(lps),
                          (extra["top_lps"] - lps).abs())
        reading["top_id_mismatches"] = int((extra["top_ids"] != ids).sum())
        reading["top_max_abs_err"] = float(err.max())
        reading["top_tie_rows"] = int(
            (logits.float().topk(6, dim=1).values.diff(dim=1) == 0)
            .any(dim=1).sum())
        bad |= (reading["top_id_mismatches"] > 0
                or not reading["top_max_abs_err"] <= 1e-5)
    if (reading["thr_k_mismatches"] or reading["thr_p_mismatches_off_near_"
                                               "ties"]
            or reading["mismatches_off_near_ties"] or not bits_ok
            or not reading["entries_equal"]
            or not reading["max_abs_err"] <= 1e-5 or bad):
        raise KernelMismatch("sample_slots", reading)
    return reading, pl


def sampler_work(args, pl):
    """(bytes, operations) the call needs on these inputs: the logits read
    once, the slots' keys, counters and settings, the tokens and logprobs
    written; the load pass over every entry, 26 count rounds over a top-k
    row, the mass set-up and 26 mass rounds over a top-p row, and the draw
    for each entry that can win: at or above the row's cut (every entry
    of a filterless row) and within 21 nats (plus a relative margin) of
    the row maximum, since a Gumbel term lies in [-4.47, 15.95]."""
    import torch
    keys, counter0, W, logits, temp, top_k, top_p, active = args
    R, V = logits.shape
    B = R // W
    nbytes = (R * V * logits.element_size() + B * (16 + counter0
              .element_size() + 4 + 4 + 4 + 1) + R * 8)
    sampled = pl["t"] > 0
    need_k = sampled & (pl["k"] > 0)
    need_p = sampled & (pl["p"] < 1.0)
    scaled = pl["scaled"]
    m = scaled.amax(dim=1)
    keep = torch.where(need_k | need_p, pl["cuts"][:, 2],
                       torch.full_like(m, -torch.inf))
    floor = torch.maximum(keep, m - (21.0 + m.abs() * 2.0 ** -20))
    drawn = torch.where(sampled & (m > -torch.inf),
                        (scaled >= floor[:, None]).sum(dim=1),
                        torch.zeros_like(m, dtype=torch.int64))
    ops = (R * V * LOAD_OPS_PER_ENTRY
           + int(need_k.sum()) * V * N_BISECT * K_ROUND_OPS_PER_ENTRY
           + int(need_p.sum()) * V * (Z_OPS_PER_ENTRY
                                     + N_BISECT * P_ROUND_OPS_PER_ENTRY)
           + int(drawn.sum()) * SAMPLE_OPS_PER_ENTRY)
    return nbytes, ops, int(drawn.sum())


def sort_sampler(args):
    """The yardstick: a sort-based sampler in torch's own calls (sort,
    softmax, cumsum, Gumbel-max with torch's generator), other numbers
    than threefry's; a function of cost, not the same function."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling
    keys, counter0, W, logits, temp, top_k, top_p, active = args
    t, k, p = sampling._live_rows(W, temp, top_k, top_p, active)
    V = logits.shape[1]
    safe_t = torch.where(t > 0, t, torch.ones_like(t))[:, None]
    k_eff = torch.where(k > 0, k, torch.full_like(k, V))[:, None]
    ranks = torch.arange(V, device=logits.device)[None]
    u = torch.empty(logits.shape, device=logits.device)

    def run():
        lf = logits.float()
        srt, idx = torch.sort(lf / safe_t, dim=-1, descending=True)
        probs = torch.softmax(srt, dim=-1)
        keep = ((probs.cumsum(-1) - probs) < p[:, None]) & (ranks < k_eff)
        keep[:, 0] = True
        u.uniform_()
        pick = torch.where(keep, srt, srt.new_full((), -torch.inf)) \
            - torch.log(-torch.log(u))
        tok = idx.gather(1, pick.argmax(dim=-1, keepdim=True))[:, 0]
        tok = torch.where(t > 0, tok, lf.argmax(dim=-1))
        return sampling.token_logprob(lf, tok)
    return run


def sampler_options(dev, args, kind, seed):
    """``sample_slots``' options for a case of ``kind`` ("mask", "advance",
    "top" or "all"), made from ``seed``: an allowed bitmask whose rows
    keep every entry, half, 5%, 0.01% and a single entry in turn, with
    row states (``mask_states``) that leave rows 2 and 6 of every 8
    unconstrained (states 0 and -1) and their words zero, so a sampler
    that read them would draw otherwise; a random
    64-state DFA (2% of its transitions to the reject state, (V, 16) token
    bytes of lengths -1 to 16) with slots at its states, unconstrained
    ones among them; ``want_top`` over
    rows where three entries tie at the row's top value and two more at
    the next (written into the logits, so bf16 rows carry them exactly).
    Returns (args, opts)."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling
    keys, counter0, W, logits, temp, top_k, top_p, active = args
    R, V = logits.shape
    B = R // W
    g = torch.Generator(device=dev).manual_seed(seed)
    opts = {}
    if kind in ("mask", "all"):
        dens = torch.tensor([1.0, 0.5, 0.05, 1e-4, 0.0], device=dev)
        keep = torch.rand((R, V), generator=g, device=dev) < dens[
            torch.arange(R, device=dev) % 5][:, None]
        one = torch.randint(0, V, (R,), generator=g, device=dev)
        keep[torch.arange(R, device=dev), one] = True
        rows = torch.arange(R, device=dev, dtype=torch.int32)
        states = torch.where(rows % 8 == 2, 0, rows + 1)
        states = torch.where(rows % 8 == 6, -1, states).to(torch.int32)
        keep[states <= 0] = False
        opts["allowed"] = sampling.pack_mask(keep)
        opts["mask_states"] = states
    if kind in ("advance", "all"):
        S = 64
        table = torch.randint(0, S, (S, 256), generator=g, device=dev,
                              dtype=torch.int32)
        # few rejecting bytes, so most walks reach the token's last byte
        table[torch.rand((S, 256), generator=g, device=dev) < 0.02] = 0
        table[0] = 0
        tok_bytes = torch.randint(0, 256, (V, 16), generator=g, device=dev,
                                  dtype=torch.int32)
        tok_lens = torch.randint(-1, 17, (V,), generator=g, device=dev,
                                 dtype=torch.int32)
        state = torch.randint(-1, S, (B,), generator=g, device=dev,
                              dtype=torch.int32)
        opts["grammar"] = (state, table, tok_bytes, tok_lens)
    if kind in ("top", "all"):
        opts["want_top"] = True
        lf = logits.float()
        top = lf.amax(dim=1)
        for r in range(0, R, 2):
            ix = torch.randint(0, V, (5,), generator=g, device=dev)
            lf[r, ix[:3]] = top[r] + 1.0
            lf[r, ix[3:]] = top[r] + 0.5
        logits = lf.to(logits.dtype)
    return (keys, counter0, W, logits, temp, top_k, top_p, active), opts


def _sample_case(dev, R, seed, kind=None, B=SAMPLE_SLOTS, V=SAMPLE_VOCAB):
    """sample_slots over R = B x W rows of llama3-8b logits (or ``V``
    entries: Gemma's 256,000), float32 and bfloat16: checked against the
    plain version (``check_sampler``), then
    timed (CUDA-graph replays) beside the plain version (the eager path of
    the parent's engine: fold_in, _mask_dynamic, the draw, token_logprob),
    the sort-based yardstick, and the bound of the work these inputs need.
    The bfloat16 call, the serving dtype, gives the entry's numbers. With
    ``kind`` the call takes ``sampler_options``' options; the top case's
    library call is ``torch.topk`` plus ``torch.logsumexp`` on the rows,
    the mask and advance cases have none."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling
    from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = sampler_inputs(dev, B, R // B, V, dtype, seed)
        opts = {}
        if kind is not None:
            args, opts = sampler_options(dev, args, kind, seed)
        reading, pl = check_sampler(args, opts)
        name = "float32" if dtype == torch.float32 else "bfloat16"
        res[name] = reading
        if CHECK_ONLY:
            continue
        nbytes, ops, drawn = sampler_work(args, pl)
        if "allowed" in opts:
            # the constrained rows' words and the rows' states
            con = int((opts["mask_states"] > 0).sum())
            nbytes += con * opts["allowed"].shape[1] * 4 + R * 4
        if opts.get("want_top"):
            nbytes += R * sampling.TOP_LP * 8
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_32BIT_OPS * 1e3
        b_ms = max(t_bytes, t_ops)
        ms = graph_ms(lambda: ks.sample_slots(*args, **opts))
        library = None
        if opts.get("want_top"):
            lf = args[3]
            library = graph_ms(lambda: (torch.topk(lf, sampling.TOP_LP,
                                                   dim=-1),
                                        torch.logsumexp(lf.float(), -1)),
                               per_graph=4)
        elif kind is None:
            library = graph_ms(sort_sampler(args), per_graph=4)
        res[name].update(
            ms=ms, plain_ms=graph_ms(lambda: sampling.sample_slots_plain(
                *args, **opts), per_graph=4),
            library_ms=library,
            bound_ms=b_ms, bound_by="operations" if t_ops >= t_bytes
            else "bytes", bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
            share_of_bound=b_ms / ms, bytes=nbytes, ops=ops,
            drawn_entries=drawn, cluster=ks.CLUSTER,
            shared_bytes_a_block=4 * ks.slice_entries(V))
    entry = dict(res["bfloat16"], float32=res["float32"],
                 tolerance="thr_k bit-equal; thr_p and tokens equal except "
                 f"at cutoff near-ties (an entry between the cutoffs and "
                 f"the mass at the higher within {CUTOFF_TIE} x z of the "
                 f"target) and draw near-ties (top two within {NEAR_TIE}); "
                 "logprobs within 1e-5; bits exact")
    if kind is not None:
        entry.update(options=kind, tolerance=entry["tolerance"]
                     + "; tokens on the mask; advanced states equal; top "
                     "ids equal (ties to the lower index), their logprobs "
                     "within 1e-5")
    if not CHECK_ONLY and kind is not None:
        entry.update(library_call=("torch.topk + torch.logsumexp"
                                   if entry.get("library_ms") else None),
                     shape=dict(R=R, B=B, W=R // B, V=V))
    elif not CHECK_ONLY:
        entry.update(
            library_call="torch sort, softmax, cumsum and Gumbel-max with "
                         "torch's generator (other numbers than threefry's; "
                         "a yardstick of cost, not of the function)",
            plain_call="sample_slots_plain: fold_in, _mask_dynamic, "
                       "categorical, token_logprob (the parent's eager "
                       "path, its draw in torch), graph-replayed",
            shape=dict(R=R, B=B, W=R // B, V=V,
                       slots="greedy, t 0.7, top-k 50, top-p 0.9, chain "
                             "0.2/0.7, both, top-p 0, top-k > V; every "
                             "fifth slot inactive"))
    return entry


# the option cases: (name, rows, options, slots)
SAMPLE_OPTION_CASES = (("mask_rows8", 8, "mask", SAMPLE_SLOTS),
                       ("advance_rows8", 8, "advance", SAMPLE_SLOTS),
                       ("top_rows40", 40, "top", SAMPLE_SLOTS),
                       ("all_rows72", 72, "all", SAMPLE_SLOTS),
                       ("all_slots12_rows108", 108, "all", 12))


def sample_cases(dev):
    """The sampler's cases, each a thunk: R = 72, 8 and 40 rows, then the
    options: the grammar mask, the advance, the top rows, all three (at 8
    slots, and at serve_tools' 12 slots of W = 9); then Gemma's 256,000
    entries at R = 72, 8 and 40 (e recomputed from s, not stored), and
    with all three options at 8 and 72 rows."""
    from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
    cases = {f"rows{R}": (lambda R=R: _sample_case(dev, R, 60 + R))
             for R in SAMPLE_ROWS}
    for name, R, kind, B in SAMPLE_OPTION_CASES:
        cases[name] = (lambda R=R, kind=kind, B=B:
                       _sample_case(dev, R, 90 + R, kind, B))
    if ks.MAX_VOCAB >= GEMMA_VOCAB:
        for R in SAMPLE_ROWS:
            cases[f"gemma_rows{R}"] = (lambda R=R: _sample_case(
                dev, R, 160 + R, V=GEMMA_VOCAB))
        for R in (8, 72):
            cases[f"gemma_all_rows{R}"] = (lambda R=R: _sample_case(
                dev, R, 190 + R, "all", V=GEMMA_VOCAB))
    return cases


def sampling_call(args):
    """A thunk of the tree's sampling call on one step's inputs:
    ``sample_slots`` where the tree has it, else the parent engine's path
    (its keys folded by ``fold_in``, the live selects, ``repeat_interleave``,
    ``sample_logits_per_slot`` with the flags the host knew, then
    ``token_logprob``): the A/B of the sampler."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling, threefry
    if hasattr(sampling, "sample_slots"):
        return lambda: sampling.sample_slots(*args)
    keys, counter0, W, logits, temp, top_k, top_p, active = args
    live = (active & (temp > 0)).cpu()
    flags = dict(any_sampled=bool(live.any()),
                 any_top_k=bool((live & (top_k > 0).cpu()).any()),
                 any_top_p=bool((live & (top_p < 1.0).cpu()).any()))
    pos = torch.arange(W, dtype=torch.int64, device=keys.device)
    rep = lambda x: x.repeat_interleave(W) if W > 1 else x

    def run():
        zero = torch.zeros((), device=keys.device)
        row_keys = threefry.fold_in(keys[:, None, :], counter0.to(
            torch.int64)[:, None] + pos[None]).reshape(-1, 2)
        tok = sampling.sample_logits_per_slot(
            row_keys, logits, rep(torch.where(active, temp, zero)),
            rep(torch.where(active, top_k, torch.zeros_like(top_k))),
            rep(torch.where(active, top_p, zero + 1.0)), **flags)
        return tok, sampling.token_logprob(logits, tok)
    return run


def ab_sampling_calls(dev):
    """The tree's sampling call at the kernel phase's cases (bf16), ms by
    CUDA-graph replay."""
    import torch
    out = {}
    for R in SAMPLE_ROWS:
        args = sampler_inputs(dev, SAMPLE_SLOTS, R // SAMPLE_SLOTS,
                              SAMPLE_VOCAB, torch.bfloat16, 60 + R)
        out[f"rows{R}"] = {"ms": graph_ms(sampling_call(args), per_graph=4)}
    return out


def phase_sample(dev):
    res = _run_cases("sample_slots", sample_cases(dev))
    emit("kernel:sample_slots", kernel_ms=res.get("ms"), **res)
    return res


# ---- the grammar mask (csrc/grammar_mask.cu)
# the nested schema and the tool set of the grammar_mask phase and of
# serve_tools
SMOKE_SCHEMA = {
    "type": "object",
    "properties": {
        "city": {"type": "string", "maxLength": 24},
        "days": {"type": "integer"},
        "units": {"type": "string", "enum": ["metric", "imperial"]},
        "stops": {"type": "array", "maxItems": 3, "items": {
            "type": "object",
            "properties": {"name": {"type": "string", "maxLength": 16},
                           "hours": {"type": "number"}},
            "required": ["name", "hours"]}}},
    "required": ["city", "days", "units", "stops"]}
SMOKE_TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather",
        "description": "Current weather of a city.",
        "parameters": {"type": "object", "properties": {
            "city": {"type": "string", "maxLength": 24},
            "unit": {"type": "string", "enum": ["c", "f"]}},
            "required": ["city", "unit"]}}},
    {"type": "function", "function": {
        "name": "search_docs",
        "description": "Search the knowledge base.",
        "parameters": {"type": "object", "properties": {
            "query": {"type": "string", "maxLength": 40},
            "top_k": {"type": "integer"}},
            "required": ["query"]}}}]
# the grammar mask's cases: (rows, slots); 108 is serve_tools' 12 slots
# of W = 9
GRAMMAR_ROWS = ((8, SAMPLE_SLOTS), (40, SAMPLE_SLOTS), (72, SAMPLE_SLOTS),
                (108, 12))
_SMOKE_TOKENIZER = {}


def smoke_tokenizer():
    """The seeded Llama-3-shaped tokenizer (``llama3_tokenizer_json``, seed
    0) written once under build/smoke_tokenizer/ and read through
    ``get_tokenizer``, with its byte table (``token_byte_table``, one host
    decode an id) and the seconds each took; cached for the process."""
    if "tok" not in _SMOKE_TOKENIZER:
        from generativeaiexamples_tpu_torch.engine import grammar
        from generativeaiexamples_tpu_torch.engine.tokenizer import (
            get_tokenizer)
        directory = os.path.join(HERE, "build", "smoke_tokenizer")
        os.makedirs(directory, exist_ok=True)
        t0 = time.perf_counter()
        spec = llama3_tokenizer_json(markdown_corpus())
        with open(os.path.join(directory, "tokenizer.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(spec, fh, ensure_ascii=False)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = get_tokenizer(directory)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tb, tl = grammar.token_byte_table(tok)
        table_s = time.perf_counter() - t0
        _SMOKE_TOKENIZER.update(
            dir=directory, tok=tok, tok_bytes=tb, tok_lens=tl,
            seconds={"tokenizer_json_s": write_s, "load_s": load_s,
                     "token_byte_table_s": table_s},
            entries=int(tb.shape[0]), never_allowed=int((tl <= 0).sum()))
    return _SMOKE_TOKENIZER


def grammar_stack(dev):
    """A GrammarStack of the engine's geometry (4 slots of 4,096 states)
    holding ``json_value()``, ``SMOKE_SCHEMA``, ``SMOKE_TOOLS`` and, in
    the fourth slot, a grammar registered over an evicted one (the first
    three pinned). Returns (stack, [(grammar, flat start state), ...]);
    cached for the process."""
    if "stack" in _SMOKE_TOKENIZER:
        return _SMOKE_TOKENIZER["stack"]
    from generativeaiexamples_tpu_torch.engine import engine
    from generativeaiexamples_tpu_torch.engine.grammar import Grammar
    stack = engine.GrammarStack(dev)
    S = engine.GRAM_STATES
    grams = [Grammar.json_value(), Grammar.from_schema(SMOKE_SCHEMA),
             Grammar.for_tools(SMOKE_TOOLS),
             Grammar.from_schema({"type": "boolean"})]
    starts = [stack.register(g) for g in grams]
    repl = Grammar.from_schema({"type": "string",
                                "enum": ["red", "green", "blue"]})
    start = stack.register(repl, [g.key for g in grams[:3]])
    if start // S != starts[3] // S or \
            grams[3].key in stack.keys:
        raise AssertionError("grammar_stack: the fourth grammar was not "
                             "evicted and its slot reused")
    _SMOKE_TOKENIZER["stack"] = (stack, list(zip(grams[:3] + [repl],
                                                 starts[:3] + [start])))
    return _SMOKE_TOKENIZER["stack"]


def gemma_byte_table():
    """The smoke tokenizer's byte table widened to Gemma's 256,000 entries:
    entries past its own 128,256 repeat a seeded draw of its entries, so
    the mask's words past llama3's 4,008 hold pieces that grammars allow,
    as a 256,000-piece vocabulary's do. Returns (bytes, lengths); cached
    for the process."""
    import numpy as np
    tk = smoke_tokenizer()
    if "gemma_table" not in tk:
        tb, tl = tk["tok_bytes"], tk["tok_lens"]
        extra = np.random.default_rng(55).integers(
            0, tb.shape[0], GEMMA_VOCAB - tb.shape[0])
        tk["gemma_table"] = (np.concatenate([tb, tb[extra]]),
                             np.concatenate([tl, tl[extra]]))
    return tk["gemma_table"]


def grammar_inputs(dev, R, seed, slots=SAMPLE_SLOTS, every_slot=False,
                   V=None):
    """One grammared sampling call's mask inputs over R = slots x W rows
    of V entries (the smoke tokenizer's by default, or Gemma's 256,000
    by ``gemma_byte_table``): the first three quarters of the slots (every
    slot with ``every_slot``) at states of the four resident grammars
    (their starts, then states drawn from each DFA), the rest
    unconstrained, budgets of 0, 3 and 8 to 40 tokens; rows w > 0
    unconstrained, as a widened step masks position 0 only. The byte
    table is the kernel's (uint8 bytes, int8 lengths, as
    ``mask_byte_table`` makes it). Returns the grammar_mask arguments."""
    import torch
    from generativeaiexamples_tpu_torch.engine.engine import GRAM_STATES
    tk = smoke_tokenizer()
    tb, tl = ((tk["tok_bytes"], tk["tok_lens"]) if V is None
              else gemma_byte_table())
    if V is not None and tb.shape[0] != V:
        raise AssertionError(f"no byte table of {V} entries")
    stack, grams = grammar_stack(dev)
    g = torch.Generator().manual_seed(seed)
    W = R // slots
    state = torch.zeros((slots, W), dtype=torch.int32)
    budget = torch.randint(8, 41, (slots, W), generator=g,
                           dtype=torch.int32)
    budget[:2, 0] = torch.tensor([0, 3], dtype=torch.int32)
    for b in range(slots if every_slot else 3 * slots // 4):
        gram, start = grams[b % 4]
        if b < 4:
            state[b, 0] = start
        else:
            slot = start // GRAM_STATES
            local = int(torch.randint(1, gram.dfa.n_states, (1,),
                                      generator=g))
            state[b, 0] = slot * GRAM_STATES + local
    table, accept, dist = stack.tensors()
    up = lambda a: torch.as_tensor(a).to(dev)
    tb = torch.as_tensor(tb).to(torch.uint8)
    tl = torch.as_tensor(tl).to(torch.int8)
    return [up(state.reshape(R)), up(budget.reshape(R)), tk["tok"].eos_id,
            table, accept, dist, up(tb), up(tl)]


def _walked_bytes(args):
    """The walks the kernel takes on these inputs (each stops at the
    reject state or the token's end) over the constrained rows: (bytes
    walked, constrained rows, distinct table entries read, distinct dist
    entries read at the walks' ends)."""
    import torch
    state, _, _, table, _, _, tok_bytes, tok_lens = args
    rows = state[state > 0].to(torch.int64)
    st = rows[:, None].expand(-1, tok_bytes.shape[0]).clone()
    walked = torch.zeros((), dtype=torch.int64, device=state.device)
    flat = table.reshape(-1).to(torch.int64)
    entries = []
    for l in range(tok_bytes.shape[1]):
        live = (tok_lens[None, :] > l) & (st != 0)
        walked += live.sum()
        ix = st * 256 + tok_bytes[None, :, l].to(torch.int64)
        entries.append(torch.unique(ix[live]))
        st = torch.where(live, flat[ix], st)
    ends = st[(st != 0) & (tok_lens[None, :] > 0)]
    return (int(walked), int(rows.numel()),
            int(torch.unique(torch.cat(entries)).numel()),
            int(torch.unique(ends).numel()))


def _grammar_check(dev, args, slots, seed):
    """One checked launch of grammar_mask: its output buffer filled with
    zeros first, then every constrained row's words equal to the packed
    plain set (``grammar_mask_plain``) bit for bit, and every
    unconstrained row's words still zero (never written). Then the
    sampler over those words with the rows' states (``mask_states``),
    bf16 logits from ``seed`` (``sampler_inputs``), held to the plain
    sampler by ``check_sampler``: a sampler that read an unconstrained
    row's zero words would draw otherwise. The reading counts the rows
    that took the fail-safe EOS (a state that does not accept, nothing
    else allowed) and the rows at accepting states. Raises
    KernelMismatch."""
    import torch
    from generativeaiexamples_tpu_torch.ops import sampling
    from generativeaiexamples_tpu_torch.ops.cuda import grammar as kg
    state, eos, accept = args[0], args[2], args[4]
    R, V = state.shape[0], args[6].shape[0]
    kg.buffers(state.device, R, V)[0].zero_()
    got = kg.grammar_mask(*args)
    want = sampling.pack_mask(sampling.grammar_mask_plain(*args))
    con = state > 0
    allowed = sampling.unpack_mask(want, V)
    accepting = con & accept[state.clamp_min(0).long()]
    reading = {"rows": R, "slots": slots,
               "constrained_rows": int(con.sum()),
               "bit_mismatches": int(
                   (sampling.unpack_mask(got[con], V)
                    != allowed[con]).sum()),
               "words_equal": bool(torch.equal(got[con], want[con])),
               "unconstrained_words_written": int((got[~con] != 0).sum()),
               "failsafe_rows": int((con & ~accepting
                                     & allowed[:, eos]).sum()),
               "accepting_rows": int(accepting.sum()),
               "allowed_per_constrained_row": [
                   int(n) for n in allowed[con].sum(dim=1)]}
    if (reading["bit_mismatches"] or not reading["words_equal"]
            or reading["unconstrained_words_written"]):
        raise KernelMismatch("grammar_mask", reading)
    sargs = sampler_inputs(dev, slots, R // slots, V, torch.bfloat16, seed)
    sread, _ = check_sampler(sargs, {"allowed": got, "mask_states": state})
    reading["sampler"] = {key: sread[key] for key in (
        "token_mismatches", "masked_rows", "tokens_off_the_mask")}
    reading["max_abs_err"] = 0.0
    return reading


def _grammar_timing(args):
    """grammar_mask timed (CUDA-graph replay) beside its plain version
    (CUDA events) and the bound of these inputs: bytes that must leave
    memory (tok_bytes as uint8 and tok_lens as int8 read once, each
    distinct table and dist entry the walks read once, the rows' states
    and budgets, the constrained rows' words written) and operations (4 a
    walked byte, 3 an (entry, constrained row))."""
    from generativeaiexamples_tpu_torch.ops import sampling
    from generativeaiexamples_tpu_torch.ops.cuda import grammar as kg
    walked, rows, table_entries, dist_entries = _walked_bytes(args)
    state, tok_bytes, tok_lens = args[0], args[6], args[7]
    R, V = state.shape[0], tok_bytes.shape[0]
    nbytes = (tok_bytes.numel() * tok_bytes.element_size()
              + tok_lens.numel() * tok_lens.element_size()
              + table_entries * 4 + dist_entries * 4 + R * 8
              + rows * -(-V // 32) * 4)
    ops = walked * 4 + rows * V * 3
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_32BIT_OPS * 1e3
    b_ms = max(t_bytes, t_ops)
    ms = graph_ms(lambda: kg.grammar_mask(*args))
    return dict(
        ms=ms, plain_ms=time_ms(lambda: sampling.pack_mask(
            sampling.grammar_mask_plain(*args)), target_ms=100.0),
        library_ms=None, bound_ms=b_ms,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        share_of_bound=b_ms / ms, bytes=nbytes, walked_bytes=walked,
        table_entries_read=table_entries, dist_entries_read=dist_entries,
        ops=ops)


def _grammar_case(dev, R, seed, slots=SAMPLE_SLOTS, every_slot=False,
                  V=None):
    """grammar_mask over R rows of V entries, checked by
    ``_grammar_check``, then timed by ``_grammar_timing``."""
    args = grammar_inputs(dev, R, seed, slots, every_slot, V)
    reading = _grammar_check(dev, args, slots, seed)
    if not CHECK_ONLY:
        reading.update(_grammar_timing(args))
    return reading


def _special_states(dev):
    """(the nested schema's start, a state of ``json_value()`` that
    accepts), flat. From the schema's start no single token completes the
    object (its shortest reply is 40 bytes), so with a budget of 0 no
    entry is allowed: the fail-safe."""
    import numpy as np
    from generativeaiexamples_tpu_torch.engine.engine import GRAM_STATES
    _, grams = grammar_stack(dev)
    (json_gram, json_start), (_, schema_start) = grams[0], grams[1]
    local = int(np.flatnonzero(json_gram.dfa.accept)[0])
    return schema_start, json_start // GRAM_STATES * GRAM_STATES + local


def _failsafe_inputs(dev, seed, V=None):
    """8 rows of 8 slots (W = 1) of V entries, 6 constrained: row 0 at the
    nested schema's start with a budget of 0 (no entry allowed: the
    fail-safe EOS), row 1 at an accepting state of ``json_value()`` (EOS
    by ``accept``), the others as ``grammar_inputs`` draws them."""
    args = grammar_inputs(dev, 8, seed, V=V)
    failsafe, accepting = _special_states(dev)
    args[0][:2] = args[0].new_tensor([failsafe, accepting])
    args[1][0] = 0
    return args


def _failsafe_case(dev, seed, V=None):
    """``_failsafe_inputs`` checked and timed; fails unless the reading
    shows both kinds of EOS row."""
    args = _failsafe_inputs(dev, seed, V)
    reading = _grammar_check(dev, args, SAMPLE_SLOTS, seed)
    if reading["failsafe_rows"] < 1 or reading["accepting_rows"] < 1:
        raise AssertionError(f"failsafe_rows8 ({args[6].shape[0]} "
                             f"entries) hit no fail-safe or no "
                             f"accepting row: {reading}")
    if not CHECK_ONLY:
        reading.update(_grammar_timing(args))
    return reading


def _two_launch_inputs(dev, seed):
    """Two launches' inputs: first 8 rows (6 constrained) with row 0 at
    ``json_value()``'s start with a budget of 8 (entries allowed, so its
    flag is set), then row 0 at the nested schema's start with a budget
    of 0 (the fail-safe) and the other constrained rows' states
    rotated."""
    import torch
    first = grammar_inputs(dev, 8, seed)
    _, grams = grammar_stack(dev)
    first[0][0], first[1][0] = grams[0][1], 8
    second = [t.clone() if isinstance(t, torch.Tensor) else t
              for t in first]
    second[0][1:6] = first[0][1:6].roll(1)
    second[0][0], second[1][0] = _special_states(dev)[0], 0
    return first, second


def _two_launch_case(dev, seed):
    """The same output and scratch buffers launched twice
    (``_two_launch_inputs``), each launch checked: a flag left set by the
    first launch would clear the second's EOS bit. Times the second
    launch."""
    first, second = _two_launch_inputs(dev, seed)
    r1 = _grammar_check(dev, first, SAMPLE_SLOTS, seed)
    reading = _grammar_check(dev, second, SAMPLE_SLOTS, seed + 1)
    reading["first_launch"] = {key: r1[key] for key in (
        "constrained_rows", "allowed_per_constrained_row")}
    if r1["allowed_per_constrained_row"][0] < 2 or \
            reading["failsafe_rows"] < 1:
        raise AssertionError(f"two_launches: row 0 was not allowed "
                             f"entries, then the fail-safe: {reading}")
    if not CHECK_ONLY:
        reading.update(_grammar_timing(second))
    return reading


def grammar_cases(dev):
    """The grammar mask's cases, each a thunk: R = 8, 40 and 72 rows of 8
    slots and 108 of 12 (6 or 9 constrained), 12 slots at W = 1 all
    constrained (``all_rows12``), a fail-safe and an accepting row
    (``failsafe_rows8``) and two launches on the same buffers
    (``two_launches``); then Gemma's 256,000 entries (8,000 words a row)
    at R = 8 and 72 and the fail-safe rows (``gemma_*``)."""
    cases = {f"rows{R}": (lambda R=R, B=B: _grammar_case(dev, R, 30 + R, B))
             for R, B in GRAMMAR_ROWS}
    cases["all_rows12"] = lambda: _grammar_case(dev, 12, 52, 12, True)
    cases["failsafe_rows8"] = lambda: _failsafe_case(dev, 53)
    cases["two_launches"] = lambda: _two_launch_case(dev, 54)
    for R in (8, 72):
        cases[f"gemma_rows{R}"] = (lambda R=R: _grammar_case(
            dev, R, 130 + R, V=GEMMA_VOCAB))
    cases["gemma_failsafe_rows8"] = lambda: _failsafe_case(dev, 153,
                                                           GEMMA_VOCAB)
    return cases


def ab_grammar(dev):
    """The tree's grammar_mask at the mask phase's seven inputs (the
    second launch of ``two_launches``) and its sampler at the option cases
    with a mask, bf16, ms by CUDA-graph replay. A tree whose mask has no
    ``buffers`` is the earlier design (a thread a (row, entry), every row
    written): it takes the int32 byte table, and its sampler takes no row
    states but reads every row's words, which that mask sets to ones on
    an unconstrained row: so it gets ones there."""
    import inspect
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import grammar as kg
    from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
    parent = not hasattr(kg, "buffers")
    inputs = {f"rows{R}": grammar_inputs(dev, R, 30 + R, B)
              for R, B in GRAMMAR_ROWS}
    inputs["all_rows12"] = grammar_inputs(dev, 12, 52, 12, True)
    inputs["failsafe_rows8"] = _failsafe_inputs(dev, 53)
    inputs["two_launches"] = _two_launch_inputs(dev, 54)[1]
    out = {}
    for name, args in inputs.items():
        if parent:
            args = args[:6] + [args[6].to(torch.int32),
                               args[7].to(torch.int32)]
        out[name] = graph_ms(lambda: kg.grammar_mask(*args))
    if not parent:
        V = inputs["rows8"][6].shape[0]
        out["floor"] = graph_ms(lambda: kg.empty_launch(dev, V))
    states = "mask_states" in inspect.signature(ks.sample_slots).parameters
    for name, R, kind, B in SAMPLE_OPTION_CASES:
        if kind not in ("mask", "all"):
            continue
        args = sampler_inputs(dev, B, R // B, SAMPLE_VOCAB, torch.bfloat16,
                              90 + R)
        args, opts = sampler_options(dev, args, kind, 90 + R)
        if not states:
            free = (opts.pop("mask_states") <= 0)[:, None]
            opts["allowed"] = torch.where(free, -1, opts["allowed"])
        out[f"sample_slots:{name}"] = graph_ms(
            lambda: ks.sample_slots(*args, **opts))
    return out


def phase_grammar(dev):
    """The grammar mask's cases, and its fixed cost: ``floor_ms``, an empty
    kernel on its grid, CUDA-graph replayed as the kernel is."""
    from generativeaiexamples_tpu_torch.ops.cuda import grammar as kg
    tk = smoke_tokenizer()
    res = _run_cases("grammar_mask", grammar_cases(dev))
    if not CHECK_ONLY:
        res["floor_ms"] = graph_ms(lambda: kg.empty_launch(dev,
                                                           tk["entries"]))
    res.update(tokenizer=dict(tk["seconds"], entries=tk["entries"],
                              never_allowed=tk["never_allowed"]),
               tolerance="bit for bit on constrained rows (the plain set "
                         "packed); unconstrained rows never written")
    emit("kernel:grammar_mask", kernel_ms=res.get("ms"), **res)
    return res


# ---------------------------------------------------------------------------
# The LoRA update (csrc/lora.cu)
# ---------------------------------------------------------------------------

# the update's shapes (in K, (out O of each target of the call)): llama3-8b's
# projections by the targets that share one shape, its two groups of
# targets that share an input (one call each), and llama3-70b's
LORA_SHAPES = {"wq_wo": (4096, (4096,)), "wk_wv": (4096, (1024,)),
               "gate_up": (4096, (14336,)), "down": (14336, (4096,)),
               "qkv_group": (4096, (4096, 1024, 1024)),
               "gate_up_group": (4096, (14336, 14336)),
               "70b_wq": (8192, (8192,)), "70b_gate_up": (8192, (28672,)),
               "70b_down": (28672, (8192,))}
LORA_SLOTS = 4          # max_adapters: the base model and three adapters
# rows (R), tokens a batch row (S): a narrow decode step of 8 slots, the
# W = 9 rung of 8 slots, the grouped prefill of 8 chunks of 512, the
# 70b smoke's mixed width (8 rows of 73)
LORA_ROWS = {"r8": (8, 1), "r72": (72, 9), "r4096": (4096, 512),
             "r584": (584, 73)}
LORA_TOLERANCE = ("per element: 2**-7 (bf16; 2**-20 f32) x (|plain result| "
                  "+ |plain update| + sum_j |z_j b_oj|) + 2**-16 x "
                  "(|x| @ |a|^T) @ |b|^T (summation order); rows of slot 0 "
                  "bit-equal to the input y")


def lora_group_inputs(dev, K, Os, r, R, S, mix, dtype, seed):
    """ys (B, S, O_t) and x (B, S, K) standard normal, stacked factors a_t
    (LORA_SLOTS, r, K) normal / sqrt(K) x 2 (lora_code's alpha / r) and
    b_t (LORA_SLOTS, O_t, r) normal x 0.1 (an update of y's size) for each
    width O_t, slot 0 random too (a read of it shows), and each batch
    row's slot: ``mix`` "mixed" cycles 0, 1, 2, 3, "one" is slot 1
    throughout, "base" 0 throughout, "global" a global adapter (slot 1's
    factors, no slots)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    B = R // S
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    ys = [rnd(B, S, O).to(dtype) for O in Os]
    x = rnd(B, S, K).to(dtype)
    a = [(rnd(LORA_SLOTS, r, K) * (2.0 / K ** 0.5)).to(dtype) for _ in Os]
    b = [(rnd(LORA_SLOTS, O, r) * 0.1).to(dtype) for O in Os]
    if mix == "global":
        return (ys, x, [t[1].contiguous() for t in a],
                [t[1].contiguous() for t in b], None)
    slots = {"mixed": [i % LORA_SLOTS for i in range(B)], "one": [1] * B,
             "base": [0] * B}[mix]
    return ys, x, a, b, torch.tensor(slots, dtype=torch.int32, device=dev)


def lora_inputs(dev, K, O, r, R, S, mix, dtype, seed):
    """``lora_group_inputs`` of one target: y, x, a, b, slots."""
    ys, x, a, b, slots = lora_group_inputs(dev, K, (O,), r, R, S, mix, dtype,
                                           seed)
    return ys[0], x, a[0], b[0], slots


def check_lora(name, y, x, a, b, slots, got):
    """The kernel's ``got`` (from ``y``) against the plain version on the
    same inputs, within ``LORA_TOLERANCE``, and rows of slot 0 bit-equal to
    ``y``. Returns the max abs error over the adapter rows, its largest
    share of the limit and the rows of each kind; raises
    KernelMismatch."""
    import torch
    from generativeaiexamples_tpu_torch.ops import lora as lora_ops
    want = lora_ops.lora_apply_plain(y, x, a, b, slots)
    if slots is None:
        ga, gb = a.float()[None], b.float()[None]
        ix = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
        take = torch.ones_like(ix, dtype=torch.bool)
    else:
        ga, gb, ix = a.float(), b.float(), slots.long()
        take = ix != 0
    dt = x.dtype
    z = torch.matmul(x, a.to(dt)[ix].transpose(1, 2) if slots is not None
                     else a.t()).float()                       # rounded z
    bb = gb[ix].transpose(1, 2)                                 # (B, r, O)
    u = torch.matmul(z, bb)
    p = torch.matmul(z.abs(), bb.abs())
    q = torch.matmul(torch.matmul(x.float().abs(),
                                  ga[ix].abs().transpose(1, 2)), bb.abs())
    ulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -20
    limit = ulp * (want.float().abs() + u.abs() + p) + 2.0 ** -16 * q
    sel = take[:, None, None].expand(want.shape)
    err = (got.float() - want.float()).abs()
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    base_equal = bool(torch.equal(got[~take].view(bits),
                                  y[~take].view(bits)))
    reading = {
        "max_abs_err": err[sel].max().item() if take.any() else 0.0,
        "max_err_over_limit": ((err / limit)[sel].max().item()
                               if take.any() else 0.0),
        "finite": bool(torch.isfinite(got).all()),
        "base_rows_bit_equal": base_equal,
        "adapter_rows": int(take.sum()) * x.shape[1],
        "base_rows": int((~take).sum()) * x.shape[1]}
    if (not reading["finite"] or not base_equal
            or reading["max_err_over_limit"] > 1.0):
        raise KernelMismatch(name, reading)
    return reading


def check_lora_group(name, ys, x, a, b, slots, got):
    """``check_lora`` for each target of a call; the worst reading, with
    the target it came from."""
    worst = None
    for t, (y, at, bt, gt) in enumerate(zip(ys, a, b, got)):
        try:
            reading = check_lora(name, y, x, at, bt, slots, gt)
        except KernelMismatch as exc:
            raise KernelMismatch(name, dict(exc.reading, target=t))
        if worst is None or (reading["max_err_over_limit"]
                             > worst["max_err_over_limit"]):
            worst = dict(reading, target=t)
    return worst


def lora_library(ys, x, a, b, slots):
    """The reference's formulation in eager PyTorch (``_maybe_lora``), once
    a target: z over all N slots (one einsum), gathered by each row's
    slot, the product with the gathered b, the add; a global adapter's (x
    a^T) b^T + y."""
    import torch
    out = []
    for y, at, bt in zip(ys, a, b):
        if slots is None:
            out.append(y + torch.matmul(torch.matmul(x, at.t()), bt.t()))
            continue
        ix = slots.long()
        za = torch.einsum("bsk,nrk->nbsr", x, at)
        z = za[ix, torch.arange(x.shape[0], device=x.device)]
        out.append(y + torch.bmm(z, bt[ix].transpose(1, 2)))
    return out


def lora_bound(x, a, b, slots, Os):
    """The least time for a call: x's adapter rows (read once for every
    target), each target's factors for each distinct adapter slot, each
    target's adapter rows of y read and written, and the slots, over the
    memory rate; 2 r (K + O_t) operations an adapter row and a target over
    the bf16 (or f32) peak. (bound ms, its kind, flops, bytes)"""
    import torch
    B, S, K = x.shape
    r = a[0].shape[-2]
    if slots is None:
        rows, distinct = B * S, 1
    else:
        ids = slots.tolist()
        rows, distinct = S * sum(1 for s in ids if s), len({s for s in ids
                                                           if s})
    esz = x.element_size()
    nbytes = float(esz * (rows * K + sum(distinct * r * (K + O) + 2 * rows * O
                                         for O in Os))
                   + (4 * B if slots is not None else 0))
    flops = float(sum(2.0 * rows * r * (K + O) for O in Os))
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ms, by = bound(flops, nbytes, peak)
    return ms, by, flops, nbytes


def lora_call(cl, ys, x, a, b, slots):
    """The tree's kernel on one call's inputs (in place into ys): the
    grouped call through factors made resident once where the tree has it,
    else (the first design) one ``lora_apply`` a target."""
    if hasattr(cl, "ResidentGroup"):
        group = cl.ResidentGroup(a, b)
        return lambda: cl.lora_apply_group(ys, x, group, slots)
    return lambda: [cl.lora_apply(y, x, at, bt, slots)
                    for y, at, bt in zip(ys, a, b)]


def _lora_case(dev, shape, r, rows, mix, dtype, seed):
    """One call at one shape: checked against its plain version (a fresh
    copy of the ys a launch), then timed by CUDA-graph replays beside the
    plain version, the reference's formulation (``lora_library``, once a
    target) and the bound; the host's time a call through the model's seam
    (``ops.lora.lora_apply_group`` over a resident group)."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.ops import lora as lora_ops
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    K, Os = LORA_SHAPES[shape]
    R, S = LORA_ROWS[rows]
    ys, x, a, b, slots = lora_group_inputs(dev, K, Os, r, R, S, mix, dtype,
                                           seed)
    got = [y.clone() for y in ys]
    lora_call(cl, got, x, a, b, slots)()
    check = check_lora_group("lora", ys, x, a, b, slots, got)
    del got
    if CHECK_ONLY:
        return check
    b_ms, b_by, flops, nbytes = lora_bound(x, a, b, slots, Os)
    yk = [y.clone() for y in ys]
    ms = graph_ms(lora_call(cl, yk, x, a, b, slots), target_ms=100.0)
    group = lora_ops.lora_group([f"t{i}" for i in range(len(Os))], a, b)
    us = host_us(lambda: lora_ops.lora_apply_group(yk, x, group, slots), 200)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    res = dict(
        **check, tolerance=LORA_TOLERANCE, ms=ms, host_us=us,
        share_of_bound=b_ms / ms,
        plain_ms=time_ms(lambda: lora_ops.lora_apply_group_plain(
            ys, x, a, b, slots), target_ms=100.0),
        library_ms=graph_ms(lambda: lora_library(ys, x, a, b, slots),
                            target_ms=100.0),
        library_call="the reference's _maybe_lora in eager PyTorch, once a "
                     "target (einsum over every slot, gather, bmm with the "
                     "gathered b, add)",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        plan=dataclasses.asdict(cl.lora_plan(
            R, K, Os, nsm, LORA_SLOTS if slots is not None else 1, r)),
        shape=dict(K=K, O=list(Os), r=r, R=R, S=S, mix=mix,
                   dtype=str(dtype).removeprefix("torch.")))
    del yk
    return res


def lora_case_shapes():
    """tag -> (shape, rank, rows, mix, dtype name, seed) of every LoRA case:
    rank 16 (lora_code) on every distinct llama3-8b projection shape at 8,
    72 and 4,096 rows with the slots mixed (base rows among them), rank 8
    (lora_pubmedqa) on wq and wk, all base rows and all one adapter at
    decode and prefill, the f32 instance and a global adapter (the dense
    API's), then the two groups of targets that share an input (one call
    each) at 8, 72 and 4,096 rows and llama3-70b's wq, gate/up and down at
    8 rows and at its mixed width, 584. The first, wq at a narrow decode
    step, is the entry's own."""
    cases = {}
    single = ("wq_wo", "wk_wv", "gate_up", "down")
    for i, (shape, rows) in enumerate(
            (s, rw) for s in single for rw in ("r8", "r72", "r4096")):
        cases[f"{shape}_r16_{rows}_mixed"] = (shape, 16, rows, "mixed",
                                              "bfloat16", 200 + i)
    cases.update({
        "wq_wo_r8_r8_mixed": ("wq_wo", 8, "r8", "mixed", "bfloat16", 220),
        "wk_wv_r8_r8_mixed": ("wk_wv", 8, "r8", "mixed", "bfloat16", 221),
        "wq_wo_r16_r8_base": ("wq_wo", 16, "r8", "base", "bfloat16", 222),
        "gate_up_r16_r4096_base": ("gate_up", 16, "r4096", "base",
                                   "bfloat16", 223),
        "wq_wo_r16_r8_one": ("wq_wo", 16, "r8", "one", "bfloat16", 224),
        "gate_up_r16_r4096_one": ("gate_up", 16, "r4096", "one", "bfloat16",
                                  225),
        "wq_wo_r16_r8_global": ("wq_wo", 16, "r8", "global", "bfloat16",
                                226),
        "wq_wo_r16_r8_mixed_f32": ("wq_wo", 16, "r8", "mixed", "float32",
                                   227)})
    for i, (shape, rows) in enumerate(
            (s, rw) for s in ("qkv_group", "gate_up_group")
            for rw in ("r8", "r72", "r4096")):
        cases[f"{shape}_r16_{rows}_mixed"] = (shape, 16, rows, "mixed",
                                              "bfloat16", 230 + i)
    for i, (shape, rows) in enumerate(
            (s, rw) for s in ("70b_wq", "70b_gate_up", "70b_down")
            for rw in ("r8", "r584")):
        cases[f"{shape}_r16_{rows}_mixed"] = (shape, 16, rows, "mixed",
                                              "bfloat16", 240 + i)
    return cases


def lora_cases(dev):
    """The LoRA kernel's cases (``lora_case_shapes``), each a thunk."""
    import torch
    return {tag: (lambda s=s, r=r, rw=rw, mix=mix, dt=dt, seed=seed:
                  _lora_case(dev, s, r, rw, mix, getattr(torch, dt), seed))
            for tag, (s, r, rw, mix, dt, seed) in lora_case_shapes().items()}


def ab_lora(dev):
    """Every LoRA case's device ms through the tree's kernel
    (``lora_call``: a tree of the first design runs a group's targets one
    call each), checked first (``--ab``)."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    out = {}
    for tag, (shape, r, rows, mix, dt, seed) in lora_case_shapes().items():
        K, Os = LORA_SHAPES[shape]
        R, S = LORA_ROWS[rows]
        ys, x, a, b, slots = lora_group_inputs(dev, K, Os, r, R, S, mix,
                                               getattr(torch, dt), seed)
        got = [y.clone() for y in ys]
        lora_call(cl, got, x, a, b, slots)()
        check_lora_group("lora", ys, x, a, b, slots, got)
        out[tag] = {"ms": graph_ms(lora_call(cl, ys, x, a, b, slots),
                                   target_ms=100.0)}
        del ys, x, a, b, slots, got
        torch.cuda.empty_cache()
    return out


def phase_lora(dev):
    res = _run_cases("lora", lora_cases(dev))
    emit("kernel:lora", kernel_ms=res.get("ms"), **res)
    return res


PROMPT_TEXT = ("The paged KV cache keeps every request's keys and values in "
               "fixed-size pages so that continuous batching never copies a "
               "sequence when it grows. ")


def _parity_report(params, cfg, prompts, got, want, dev, label,
                   adapters=None):
    """Kernel vs plain greedy streams: equal, or diverging only where the
    plain forward's top-2 logits (under the global adapter tree
    ``adapters``, if any) are within PARITY_GAP_TOL."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    report = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            report.append({"prompt": i, "identical": True, "tokens": len(a)})
            continue
        step = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        ids = torch.tensor([prompts[i] + b[:step]], device=dev)
        with torch.no_grad():
            logits = llama.forward(params, cfg, ids, adapters=adapters)[0, -1]
        top2 = logits.topk(2).values
        gap = (top2[0] - top2[1]).item()
        report.append({"prompt": i, "identical": False, "step": step,
                       "top2_gap": gap})
        if gap >= PARITY_GAP_TOL:
            emit("parity", ok=False, path=label, streams=report)
            raise AssertionError(f"{label}: kernel and plain streams diverge "
                                 f"at step {step} with top-2 gap {gap}")
    return report


def _dense_greedy(params, cfg, prompts, steps, T, dev, adapters=None):
    """Greedy tokens of the dense-cache API: one right-padded prefill of
    every prompt (last_only), then ``steps`` decode steps, under the
    global adapter tree ``adapters`` if given."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    B, S = len(prompts), max(len(p) for p in prompts)
    tokens = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32, device=dev)
    seq = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=dev)
    cache = llama.KVCache.create(cfg, B, T, device=dev)
    with torch.no_grad():
        logits, cache = llama.prefill(params, cfg, tokens, cache,
                                      torch.zeros_like(seq), seq,
                                      last_only=True, adapters=adapters)
        if logits.shape != (B, 1, cfg.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"dense prefill gave {tuple(logits.shape)} "
                                 f"or non-finite logits")
        tok = logits[:, 0].argmax(-1)
        out = [tok]
        for _ in range(steps - 1):
            logits, cache = llama.decode_step(params, cfg, tok, cache,
                                              adapters=adapters)
            tok = logits.argmax(-1)
            out.append(tok)
    return torch.stack(out, dim=1).tolist()


def _staggered_streams(sched, prompts, first_tokens, rest_tokens):
    """Greedy output ids of ``prompts`` through a started scheduler: the
    first alone, the rest submitted once its first decode dispatch ran (so
    their chunks can ride the decode dispatch)."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    first = sched.submit(Request(prompt_ids=prompts[0],
                                 max_tokens=first_tokens, temperature=0.0))
    t0 = time.perf_counter()
    while sched.stats["decode_dispatches"] < 1:
        if first.finished_at or time.perf_counter() - t0 > 300:
            raise AssertionError("the first request never reached decode")
        time.sleep(0.005)
    reqs = [first] + [sched.submit(Request(prompt_ids=p, max_tokens=rest_tokens,
                                           temperature=0.0))
                      for p in prompts[1:]]
    for r in reqs:
        list(sched.iter_text(r))
    if any(r.error for r in reqs):
        raise AssertionError(f"a request failed: {[r.error for r in reqs]}")
    return [r.output_ids for r in reqs]


def phase_parity(dev):
    """8B width, 2 layers, f32, same weights, greedy: over a model-dtype
    pool and an int8 pool, the engine's kernel path against its plain path
    on the narrow two-dispatch path (speculation and the mixed dispatch
    off) and on the default one (speculation on, the mixed dispatch on, a
    prompt arriving while the first decodes), and speculation on against
    off on the kernel path; and the dense-cache API, kernel against
    plain."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype="float32")
    params = llama.init_params(torch.Generator(device=dev).manual_seed(3),
                               cfg, device=dev)
    tok = ByteTokenizer()
    prompts = [tok.encode(PROMPT_TEXT * 2, add_bos=True),
               tok.encode(PROMPT_TEXT * 5, add_bos=True)]   # two chunks
    # the spec+mixed path without the prefill hold, so the second prompt
    # (arriving while one slot decodes, a ramp) rides a mixed dispatch
    paths = {"narrow": NARROW, "spec_mixed": dict(prefill_hold_chunks=0)}
    reports, dispatches = {}, {}
    for kv_quant in ("none", "int8"):
        streams = {}
        for path, knobs in paths.items():
            for attn in ("kernel", "plain"):
                ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048,
                                    page_size=128, prefill_chunk=512,
                                    dtype="float32", attention=attn,
                                    kv_quant=kv_quant, **knobs)
                sched = Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id,
                                             device=dev), tok)
                k.reset_launch_counts()
                sched.start()
                try:
                    streams[path, attn] = _staggered_streams(sched, prompts,
                                                             96, 24)
                finally:
                    sched.stop()
                key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                       else "ragged_paged_attention")
                if attn == "kernel" and k.launch_counts()[key] == 0:
                    raise AssertionError(f"parity run ({kv_quant}, {path}) "
                                         f"did not launch {key}")
                if path == "spec_mixed" and not (
                        sched.stats["mixed_dispatches"]
                        and sched.stats["spec_steps"]):
                    raise AssertionError(f"parity run ({kv_quant}, {attn}) "
                                         f"ran no mixed or widened step: "
                                         f"{sched.stats}")
                dispatches[f"{kv_quant}, {path}, {attn}"] = dict(sched.stats)
        for label, a, b in (("kernel vs plain, narrow", ("narrow", "kernel"),
                             ("narrow", "plain")),
                            ("kernel vs plain, spec+mixed",
                             ("spec_mixed", "kernel"),
                             ("spec_mixed", "plain")),
                            ("spec+mixed vs narrow, kernel",
                             ("spec_mixed", "kernel"), ("narrow", "kernel"))):
            label = f"engine, kv_quant={kv_quant}, {label}"
            reports[label] = _parity_report(params, cfg, prompts, streams[a],
                                            streams[b], dev, label)
    dense = {attn: _dense_greedy(params, dataclasses.replace(
        cfg, attn_impl=attn), prompts, 24, 1024, dev)
        for attn in ("kernel", "plain")}
    reports["dense API"] = _parity_report(params, cfg, prompts,
                                          dense["kernel"], dense["plain"],
                                          dev, "dense API")
    emit("parity", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         streams=reports, dispatches=dispatches)
    _prefix_parity(dev, params, cfg, tok)
    _pipeline_parity(dev, params, cfg, tok)
    del params


def phase_parity_w8(dev):
    """int8 weights at llama3-8b width, 2 layers, f32, greedy, the
    reference's defaults (no prefill hold, so the second prompt rides a
    mixed dispatch), over a model-dtype pool and an int8 pool: the kernel
    path (the attention kernels and ``w8a16_gemm``'s f32 instance) against
    the plain path (plain attention, ``w8a16_gemm_plain``), on weights
    drawn from one seed and quantized as drawn."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    from generativeaiexamples_tpu_torch.ops.cuda import quant as cq

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype="float32")
    params = llama.init_params(torch.Generator(device=dev).manual_seed(3),
                               cfg, device=dev, quant="int8")
    tok = ByteTokenizer()
    prompts = [tok.encode(PROMPT_TEXT * 2, add_bos=True),
               tok.encode(PROMPT_TEXT * 5, add_bos=True)]
    kernel_gemm = cq.w8a16_gemm
    reports, launches = {}, {}
    for kv_quant in ("none", "int8"):
        streams = {}
        for attn in ("kernel", "plain"):
            ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048,
                                page_size=128, prefill_chunk=512,
                                dtype="float32", attention=attn,
                                kv_quant=kv_quant, quant="int8",
                                prefill_hold_chunks=0)
            sched = Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id,
                                         device=dev), tok)
            cq.w8a16_gemm = (kernel_gemm if attn == "kernel"
                             else cq.w8a16_gemm_plain)
            k.reset_launch_counts()
            sched.start()
            try:
                streams[attn] = _staggered_streams(sched, prompts, 96, 24)
            finally:
                sched.stop()
                cq.w8a16_gemm = kernel_gemm
            launches[f"{kv_quant}, {attn}"] = k.launch_counts()
            if (k.launch_counts()["w8a16_gemm"] > 0) != (attn == "kernel"):
                raise AssertionError(f"parity_w8 ({kv_quant}, {attn}): "
                                     f"launches {k.launch_counts()}")
            if not sched.stats["mixed_dispatches"]:
                raise AssertionError(f"parity_w8 ({kv_quant}, {attn}) ran "
                                     f"no mixed dispatch: {sched.stats}")
        label = f"engine, quant=int8, kv_quant={kv_quant}, kernel vs plain"
        reports[label] = _parity_report(params, cfg, prompts,
                                        streams["kernel"], streams["plain"],
                                        dev, label)
    emit("parity_w8", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         streams=reports, launches=launches)
    del params


def smoke_adapters(dev, cfg, names, dtype, seed, sigma):
    """Adapters in the ``lora_code`` layout (rank 16, alpha 32, all seven
    targets), one a name, drawn on the card from ``seed``: ``a`` as
    ``init_adapters`` draws it, ``b`` normal times ``sigma`` (a trained
    adapter's ``b`` is not zero), in ``dtype``."""
    import torch
    from generativeaiexamples_tpu_torch.train import lora
    lcfg = lora.LoraConfig(rank=16, alpha=32.0, targets=lora.TARGETS)
    out = {}
    for i, name in enumerate(names):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        tree = lora.init_adapters(g, cfg, lcfg, device=dev)
        out[name] = {t: {"a": ab["a"].to(dtype),
                         "b": (torch.randn(ab["b"].shape, generator=g,
                                           device=dev) * sigma).to(dtype)}
                     for t, ab in tree.items()}
    return out


LORA_NAMES = ("ad-1", "ad-2", "ad-3")
LORA_LOGITS_TOL = 1e-3   # of the largest plain logit: f32 summation order


def lora_apply_group_plain_resident(ys, x, group, slots):
    """The plain version over a resident group's factors: what the plain
    pass takes in place of ``ops.cuda.lora.lora_apply_group``."""
    from generativeaiexamples_tpu_torch.ops import lora as lora_ops
    return lora_ops.lora_apply_group_plain(ys, x, group.a, group.b, slots)


class _PlainLora:
    """While entered, ``ops.cuda.lora.lora_apply_group`` is the plain
    version (the plain pass asks for it by name, as ``parity_w8`` does for
    the GEMM): no ``lora`` launch."""

    def __enter__(self):
        from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
        self._kernel = cl.lora_apply_group
        cl.lora_apply_group = lora_apply_group_plain_resident
        return self

    def __exit__(self, *exc):
        from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
        cl.lora_apply_group = self._kernel


def _parity_lora_setup(dev):
    """The parity phases' model (llama3-8b width, 2 layers, f32, seed 3),
    three adapters (``smoke_adapters``, f32) and two prompts (one of two
    chunks)."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype="float32")
    params = llama.init_params(torch.Generator(device=dev).manual_seed(3),
                               cfg, device=dev)
    trees = smoke_adapters(dev, cfg, LORA_NAMES, torch.float32, 40, 0.05)
    tok = ByteTokenizer()
    prompts = [tok.encode(PROMPT_TEXT * 2, add_bos=True),
               tok.encode(PROMPT_TEXT * 5, add_bos=True)]
    return cfg, params, trees, tok, prompts


def _lora_core(dev, cfg, params, tok, attn, adapters=None, trees=None):
    """A parity engine (8 slots of 2,048, the reference's defaults, no
    prefill hold) on the kernel or the plain path, with a global tree or
    ``trees`` registered."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048, page_size=128,
                        prefill_chunk=512, dtype="float32", attention=attn,
                        prefill_hold_chunks=0)
    core = EngineCore(cfg, ecfg, params, tok.eos_id, device=dev,
                      adapters=adapters)
    for name, tree in (trees or {}).items():
        core.register_adapter(name, tree)
    return core


def _lora_batch(core, tok, specs, tokens):
    """``specs`` ((adapter, prompt ids, temperature, seed), ...) submitted
    at once to a new Scheduler over ``core``; the output ids, the stats,
    the launches, the forward passes and those among them that made the
    LoRA update (``core.lora_passes``)."""
    from generativeaiexamples_tpu_torch.engine.scheduler import (Request,
                                                                 Scheduler)
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    sched = Scheduler(core, tok)
    reqs = [Request(prompt_ids=list(p), max_tokens=tokens, temperature=t,
                    seed=seed, adapter=ad) for ad, p, t, seed in specs]
    lora_passes = core.lora_passes
    with _ForwardCount() as fwd:
        k.reset_launch_counts()
        sched.start()
        try:
            for r in reqs:
                sched.submit(r)
            for r in reqs:
                list(sched.iter_text(r))
        finally:
            sched.stop()
        launches = k.launch_counts()
    if any(r.error for r in reqs):
        raise AssertionError(f"a request failed: {[r.error for r in reqs]}")
    return reqs, [r.output_ids for r in reqs], dict(sched.stats), launches, \
        fwd.blocks, core.lora_passes - lora_passes


def _lora_logits(core, cfg, dev, seed=11):
    """Logits of one grouped prefill of 4 chunks (slots 0 to 3: the base
    model and each adapter) through the core's paged pass and adapters."""
    import torch
    from generativeaiexamples_tpu_torch.engine import kv_cache
    g = torch.Generator(device=dev).manual_seed(seed)
    G, C, ps = 4, 512, 128
    cache = kv_cache.PagedKVCache.create(cfg, G, 1 + G * 4, ps, device=dev)
    tokens = torch.randint(0, 256, (G, C), generator=g, device=dev,
                           dtype=torch.int32)
    rows = (1 + torch.arange(G * 4, device=dev, dtype=torch.int32)
            ).reshape(G, 4)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    with torch.no_grad():
        return kv_cache.prefill_chunks(
            core.params, core.model_cfg, tokens, cache, rows,
            i32([0, 1, 2, 3]),
            i32([0] * G), i32([512, 300, 450, 97]), 1 + G * 4,
            adapters=core.adapters, adapter_ix=i32([0, 1, 2, 3]))


def phase_parity_lora(dev):
    """Multi-LoRA at llama3-8b width, 2 layers, f32, the reference's
    defaults (the mixed dispatch off once adapters are resident): a mixed
    batch of the base model and three adapters, greedy and seeded, through
    the kernel path (the attention kernels, ``lora_apply``'s f32 instance)
    against the plain path (plain attention, ``lora_apply_plain``): the
    logits of a grouped prefill of the four within ``LORA_LOGITS_TOL``
    and the streams token for token (``_sampled_parity_report``); then
    each adapter's requests alone on a global-adapter engine, kernel path,
    equal to their streams in the mixed batch."""
    import torch
    cfg, params, trees, tok, prompts = _parity_lora_setup(dev)
    ids = [""] + list(LORA_NAMES)
    # greedy on the two-chunk prompt, seeded on the other, each under the
    # base model and every adapter
    specs = ([(ad, prompts[1], 0.0, i) for i, ad in enumerate(ids)]
             + [(ad, prompts[0], 0.7, 20 + i) for i, ad in enumerate(ids)])
    runs, logits, groups = {}, {}, 0
    for attn in ("kernel", "plain"):
        core = _lora_core(dev, cfg, params, tok, attn, trees=trees)
        groups = core.lora_groups
        if core.mixed_supported:
            raise AssertionError("the mixed dispatch is on with adapters "
                                 "resident")
        if attn == "plain":
            with _PlainLora():
                logits[attn] = _lora_logits(core, cfg, dev)
                runs[attn] = _lora_batch(core, tok, specs, 48)
        else:
            logits[attn] = _lora_logits(core, cfg, dev)
            runs[attn] = _lora_batch(core, tok, specs, 48)
        del core
        torch.cuda.empty_cache()
    reqs, got, stats, launches, passes, lora_passes = runs["kernel"]
    _, want, _, plain_launches, _, _ = runs["plain"]
    # one call a group of targets that share an input and a layer in each
    # pass with an adapter row
    need = groups * cfg.n_layers * lora_passes
    if (launches["lora"] != need or need == 0 or plain_launches["lora"]
            or not 0 < lora_passes <= passes or groups != 4):
        raise AssertionError(f"parity_lora: {launches['lora']} lora launches "
                             f"for {lora_passes} of {passes} forward passes "
                             f"with adapter rows, {groups} groups a layer "
                             f"(want {need}); the plain pass launched "
                             f"{plain_launches['lora']}")
    if stats["mixed_dispatches"] or not stats["spec_steps"]:
        raise AssertionError(f"parity_lora ran a mixed dispatch or no "
                             f"widened step: {stats}")
    err = (logits["kernel"] - logits["plain"]).abs().max().item()
    limit = LORA_LOGITS_TOL * logits["plain"].abs().max().item()
    if not err <= limit:
        raise KernelMismatch("parity_lora", {"logits_max_abs_err": err,
                                             "limit": limit})
    report = {"mixed batch, kernel vs plain": _sampled_parity_report(
        params, cfg, reqs, got, want, dev, "parity_lora", trees)}
    if any(got[i] == got[0] for i in (1, 2, 3)):
        raise AssertionError("parity_lora: an adapter's greedy stream equals "
                             "the base model's")
    solo = {}
    for name in LORA_NAMES:
        rows = [i for i, s in enumerate(specs) if s[0] == name]
        core = _lora_core(dev, cfg, params, tok, "kernel",
                          adapters=trees[name])
        sreqs, sgot, _, slaunch, spasses, slora = _lora_batch(
            core, tok, [("",) + specs[i][1:] for i in rows], 48)
        sgroups = core.lora_groups
        del core
        if (slaunch["lora"] != sgroups * cfg.n_layers * spasses
                or slora != spasses):
            raise AssertionError(f"parity_lora global {name}: launches "
                                 f"{slaunch}")
        report[f"{name} alone on a global-adapter engine vs the mixed "
               f"batch"] = _sampled_parity_report(
            params, cfg, sreqs, sgot, [got[i] for i in rows], dev,
            "parity_lora", {"": trees[name]})
        solo[name] = slaunch["lora"]
    emit("parity_lora", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         logits_max_abs_err=err, logits_limit=limit,
         logits_tolerance=f"{LORA_LOGITS_TOL} x the largest plain logit",
         streams=report, dispatches=stats, launches=launches,
         forward_passes=passes, lora_passes=lora_passes,
         lora_groups_a_layer=groups, global_engine_lora_launches=solo,
         requests=[{"adapter": s[0] or "base", "temperature": s[2],
                    "tokens": len(g)} for s, g in zip(specs, got)])
    del params, trees


def parity_lora_cases(dev):
    """``phase_parity_lora`` as one check-only case (the planted faults
    read it): a failed check of any kind is its reading."""
    def case():
        try:
            phase_parity_lora(dev)
        except KernelMismatch:
            raise
        except AssertionError as exc:
            raise KernelMismatch("parity_lora", {"error": str(exc)[:400]})
        return {"passed": True}
    return {"streams": case}


def phase_dense_lora(dev, rows=8, steps=24, T=1024):
    """The dense-cache API with a global adapter tree (``smoke_adapters``'
    first, f32) at llama3-8b width, 2 layers, f32: one prefill of ``rows``
    prompts of 64 to 512 tokens and ``steps`` greedy decode steps through
    ``flash_prefill``, ``ragged_decode`` and ``lora_apply`` (launch counts
    set to 0 just before, read just after), against the plain path
    (plain attention, ``lora_apply_plain``), stream for stream. Returns
    the kernel path's launches."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.ops import lora as lora_ops
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    cfg, params, trees, _, _ = _parity_lora_setup(dev)
    tree = trees["ad-1"]
    groups = lora_ops.group_count(lora_ops.prepare(tree, cfg.n_layers))
    lens = [64 + (512 - 64) * i // (rows - 1) for i in range(rows)]
    g = torch.Generator(device=dev).manual_seed(5)
    prompts = [torch.randint(0, 256, (n,), generator=g, device=dev).tolist()
               for n in lens]
    streams, launches = {}, {}
    for attn in ("kernel", "plain"):
        acfg = dataclasses.replace(cfg, attn_impl=attn)
        k.reset_launch_counts()
        if attn == "plain":
            with _PlainLora():
                streams[attn] = _dense_greedy(params, acfg, prompts, steps, T,
                                              dev, tree)
        else:
            streams[attn] = _dense_greedy(params, acfg, prompts, steps, T,
                                          dev, tree)
        launches[attn] = k.launch_counts()
    L, got = cfg.n_layers, launches["kernel"]
    if (got["flash_prefill"] != L or got["ragged_decode"] != L * (steps - 1)
            or got["lora"] != groups * L * steps
            or any(launches["plain"].values())):
        raise AssertionError(f"dense_lora launches: {launches}")
    report = _parity_report(params, cfg, prompts, streams["kernel"],
                            streams["plain"], dev, "dense_lora", tree)
    emit("dense_lora", ok=True, rows=rows, prompt_lens=lens,
         decode_steps=steps, cache_rows=T, tolerance_top2_gap=PARITY_GAP_TOL,
         streams=report, launches=launches)
    return got


LORA_PROBE = "LoRA probe. " + PROMPT_TEXT * 3    # its own first page


def _lora_serve_checks(base, submitted, base_id, names):
    """``serve_lora``'s checks on the server once its traffic is done:
    ``/v1/models`` lists each adapter with the base model as its parent;
    an unknown id gets a 404; one prompt (``LORA_PROBE``, 3 full pages)
    under the base model, each adapter, then the first adapter again, one
    at a time, greedy: every reply echoes its id, each adapter's tokens
    differ from the base model's, no run shares another model's cached
    pages, and the first adapter's second run shares its first's."""
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as resp:
        cards = json.loads(resp.read())["data"]
    listed = {c["id"]: c.get("parent") for c in cards}
    if listed != {base_id: None, **{n: base_id for n in names}}:
        raise AssertionError(f"/v1/models lists {listed}")
    try:
        _request(base, 0, "hi", 4, chat=True, stream=False,
                 temperature=0.0, model="no-such-adapter")
        raise AssertionError("an unknown model id was served")
    except urllib.error.HTTPError as exc:
        if exc.code != 404:
            raise AssertionError(f"an unknown model id got {exc.code}")
    runs = []
    for m in [base_id] + names + names[:1]:
        n0 = len(submitted)
        r = _request(base, 0, LORA_PROBE, 16, chat=False, stream=False,
                     temperature=0.0, model=m)
        req = submitted[n0]
        runs.append({"model": m, "status": r["status"], "echoed": r["model"],
                     "tokens": len(req.output_ids),
                     "prefix_hit_tokens": req.prefix_hit_tokens,
                     "ids": list(req.output_ids)})
    faults = [f"{run['model']} echoed {run['echoed']}" for run in runs
              if run["echoed"] != [run["model"]] or run["status"] != 200]
    for run in runs[1:-1]:
        if run["ids"] == runs[0]["ids"]:
            faults.append(f"{run['model']} answered as the base model")
    faults += [f"{run['model']} shared {run['prefix_hit_tokens']} cached "
               f"tokens of another model" for run in runs[:-1]
               if run["prefix_hit_tokens"]]
    if runs[-1]["prefix_hit_tokens"] <= 0:
        faults.append(f"{names[0]}'s second run shared no page of its first")
    if faults:
        raise AssertionError(f"serve_lora: {'; '.join(faults)}")
    for run in runs:
        del run["ids"]
    return {"models": listed, "unknown_model_status": 404,
            "probe_prompt_bytes": len(LORA_PROBE), "probe_runs": runs}


# the prefix phases' shared context (1,536 bytes, a RAG chain's retrieved
# text) and questions of 64 to 256 bytes, each starting with its own byte,
# so any two prompts share exactly the context
CONTEXT_TEXT = (PROMPT_TEXT * 11)[:1536]
QUESTION_BYTES = (64, 96, 128, 160, 192, 224, 256, 80, 72, 112, 144, 200)
QUESTIONS = [(f"{chr(65 + i)}: which pages does request {i} share? "
              + "Answer from the context above. " * 9)[:n]
             for i, n in enumerate(QUESTION_BYTES)]


def _wait_for(cond, what, timeout=600):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what} within {timeout} s")
        time.sleep(0.002)


def _prefix_traffic(sched, tok, tight):
    """Greedy requests through a started scheduler, by token ids. Roomy:
    context + question 0 alone; once its first token is out, two other
    questions and a repeat of the first prompt (hits while it decodes);
    after all finish, a follow-up turn embedding the first prompt and its
    generated ids (a hit on decode-written pages). Tight: one at a time,
    a prompt, one over a rotated context, the first again (a hit), and a
    third, which the small pool serves by evicting cached pages."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Request

    def run(ids_list, max_tokens):
        reqs = [sched.submit(Request(prompt_ids=ids, max_tokens=max_tokens,
                                     temperature=0.0)) for ids in ids_list]
        for r in reqs:
            list(sched.iter_text(r))
        return reqs

    q = lambda i: tok.encode(QUESTIONS[i])
    context = tok.encode(CONTEXT_TEXT, add_bos=True)
    if tight:
        texts = [tok.encode(CONTEXT_TEXT[k:] + CONTEXT_TEXT[:k], add_bos=True)
                 for k in (0, 500, 0, 1000)]
        reqs = []
        for i, ids in enumerate(texts):
            reqs += run([ids + q(i % 2)], 24)
    else:
        first = sched.submit(Request(prompt_ids=context + q(0),
                                     max_tokens=160, temperature=0.0))
        _wait_for(lambda: first.first_token_at or first.finished_at,
                  "no first token")
        reqs = [first] + run([context + q(1), context + q(2), context + q(0)],
                             24)
        list(sched.iter_text(first))
        reqs += run([first.prompt_ids + first.output_ids + q(7)], 24)
    if any(r.error for r in reqs):
        raise AssertionError(f"a request failed: {[r.error for r in reqs]}")
    return reqs


def _prefix_parity(dev, params, cfg, tok):
    """The prefix cache on against off on the kernel path (speculation and
    the mixed dispatch at their defaults), both pools, roomy and tight
    traffic: the same greedy tokens (or a divergence at a near-tie)."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    reports, readings = {}, {}
    for kv_quant in ("none", "int8"):
        for tight in (False, True):
            key = f"kv_quant={kv_quant}, {'tight' if tight else 'roomy'}"
            streams = {}
            for cache in ("on", "off"):
                # no prefill hold: the roomy wave arrives while one slot
                # decodes (a ramp) and is to ride mixed dispatches
                ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048,
                                    page_size=128, prefill_chunk=512,
                                    dtype="float32", attention="kernel",
                                    kv_quant=kv_quant, prefix_cache=cache,
                                    num_pages=36 if tight else 0,
                                    prefill_hold_chunks=0)
                sched = Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id,
                                             device=dev), tok)
                k.reset_launch_counts()
                sched.start()
                try:
                    reqs = _prefix_traffic(sched, tok, tight)
                finally:
                    sched.stop()
                streams[cache] = [r.output_ids for r in reqs]
                if cache == "on":
                    on = dict(sched.stats)
                    hits = [r.prefix_hit_tokens for r in reqs]
                    readings[key] = {
                        "prefix_hit_tokens": hits,
                        "prompt_tokens": [len(r.prompt_ids) for r in reqs],
                        "launches": k.launch_counts(),
                        **{name: on[name] for name in (
                            "prefix_evictions", "admission_skips",
                            "mixed_dispatches", "prefill_dispatches")}}
            reports[key] = _parity_report(
                params, cfg, [r.prompt_ids for r in reqs], streams["on"],
                streams["off"], dev, f"prefix cache on vs off, {key}")
            if tight and (on["prefix_evictions"] < 1 or hits[2] <= 0):
                raise AssertionError(f"{key}: no eviction or no hit: {hits}, "
                                     f"{on}")
            if not tight and (min(hits[1:]) <= 0
                              or on["mixed_dispatches"] < 1):
                raise AssertionError(f"{key}: hits {hits}, {on}")
    emit("parity_prefix", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         streams=reports, prefix=readings)


def _sampled_parity_report(params, cfg, reqs, got, want, dev, label,
                           adapters=None):
    """Streams of greedy and seeded sampled requests, token for token: a
    divergence is accepted only at a near-tie of the plain f32 forward at
    that step (under the request's adapter: ``adapters`` maps names to
    trees), the top two logits for a greedy request and the top two
    masked logits plus the request's Gumbel draw (its key folded with the
    token's index) for a sampled one, within PARITY_GAP_TOL."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import sampling, threefry
    report = []
    for i, (r, a, b) in enumerate(zip(reqs, got, want)):
        if a == b:
            report.append({"request": i, "identical": True,
                           "tokens": len(a), "temperature": r.temperature})
            continue
        step = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        ids = torch.tensor([r.prompt_ids + b[:step]], device=dev)
        tree = (adapters or {}).get(r.adapter)
        with torch.no_grad():
            logits = llama.forward(params, cfg, ids,
                                   adapters=tree)[0, -1:].float()
        if r.temperature > 0:
            logits = sampling._mask_dynamic(
                logits, torch.tensor([r.temperature], device=dev),
                torch.tensor([r.top_k], dtype=torch.int32, device=dev),
                torch.tensor([r.top_p], device=dev))
            key = threefry.fold_in(threefry.prng_key(r.seed), step)
            logits = logits + threefry.gumbel(key[None].to(dev),
                                              logits.shape[-1])
        top2 = logits[0].topk(2).values
        gap = (top2[0] - top2[1]).item()
        report.append({"request": i, "identical": False, "step": step,
                       "top2_gap": gap, "temperature": r.temperature})
        if gap >= PARITY_GAP_TOL:
            emit("parity_pipeline", ok=False, path=label, streams=report)
            raise AssertionError(f"{label}: streams diverge at request {i} "
                                 f"step {step} with top-2 gap {gap}")
    return report


def _drive_waves(sched, waves, timeout=600):
    """Submit each wave once every request of the one before has its
    first token, ticking the scheduler in this thread; tick until all
    finish."""
    reqs = []
    t0 = time.perf_counter()
    for i, wave in enumerate(waves):
        while i and not all(r.first_token_at or r.finished_at for r in reqs):
            sched._tick()
            if time.perf_counter() - t0 > timeout:
                raise AssertionError("a wave never got its first tokens")
        reqs += [sched.submit(r) for r in wave]
    while not all(r.finished_at for r in reqs):
        sched._tick()
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("requests did not finish")
    if any(r.error for r in reqs):
        raise AssertionError(f"a request failed: {[r.error for r in reqs]}")
    return reqs


def _pipeline_waves(tok):
    """A greedy request and two seeded sampled ones of 4 chunks (9 chunks
    in all: the ramp outlasts one grouped prefill, so decode is held),
    then, once all three have their first token, a greedy, a top-p
    sampled one and one at the chain server's temperature 0.2 / top-p 0.7
    arriving while 3 of 8 slots decode (another ramp)."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    enc = lambda n: tok.encode(PROMPT_TEXT * n, add_bos=True)
    return [[Request(prompt_ids=enc(2), max_tokens=96, temperature=0.0),
             Request(prompt_ids=enc(13), max_tokens=64, temperature=0.7,
                     seed=1),
             Request(prompt_ids=enc(13)[::-1], max_tokens=64,
                     temperature=0.7, top_k=50, seed=2)],
            [Request(prompt_ids=enc(5), max_tokens=24, temperature=0.0),
             Request(prompt_ids=enc(3), max_tokens=24, temperature=0.7,
                     top_p=0.9, seed=3),
             Request(prompt_ids=enc(4)[::-1], max_tokens=24,
                     temperature=0.2, top_p=0.7, seed=4)]]


LAG_MS = 150.0   # device time a lagging dispatch spins first


def _lag_cycles(ms):
    """SM clock cycles of ``torch.cuda._sleep`` that spin ``ms`` on this
    card (timed once with CUDA events)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return int(ms * 10 ** 7 / start.elapsed_time(end))


def _lagging(core, cycles):
    """Make the device lag the host: every decode and mixed dispatch of
    ``core`` ends its device work with a spin kernel, queued after its
    packed result and before that result's copy to the host, so the
    result lands after the host has issued the next dispatch. (A spin
    queued first would not do: the host may run only a launch queue's
    depth ahead of the card, so it would wait inside the dispatch.)"""
    import torch
    pack = core._pack

    def spun(outs):
        res = pack(outs)
        torch.cuda._sleep(cycles)
        return res
    core._pack = spun


def _pipeline_parity(dev, params, cfg, tok):
    """The reference's default dispatch loop on the kernel path (2 layers,
    f32), both pools: the defaults (two dispatches in flight, the hold,
    the width ladder, the sampling kernel) against the plain sampler
    (``sample_slots_plain`` in place of ``sample_slots``, same config), against pipeline_depth 1, against the ladder off, and
    against the defaults on a device that lags (each dispatch spins
    ``LAG_MS`` first, so results land after the next dispatch is issued:
    two dispatches in flight through the pinned copies and CUDA events,
    which must overlap and stay in flight up to the depth), greedy and
    seeded sampled streams token for token."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.ops import sampling
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    variants = {"defaults": {}, "plain_sampler": {},
                "depth1": dict(pipeline_depth=1),
                "ladder_off": dict(decode_width_ladder="off"),
                "lagging_device": {}}
    lag = _lag_cycles(LAG_MS)
    reports, readings = {}, {}
    kernel_sample = sampling.sample_slots
    for kv_quant in ("none", "int8"):
        streams = {}
        for name, knobs in variants.items():
            ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048,
                                page_size=128, prefill_chunk=512,
                                dtype="float32", attention="kernel",
                                kv_quant=kv_quant, **knobs)
            sched = Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id,
                                         device=dev), tok)
            if name == "lagging_device":
                _lagging(sched.core, lag)
            k.reset_launch_counts()
            if name == "plain_sampler":
                sampling.sample_slots = sampling.sample_slots_plain
            try:
                reqs = _drive_waves(sched, _pipeline_waves(tok))
            finally:
                sampling.sample_slots = kernel_sample
            streams[name] = [r.output_ids for r in reqs]
            st, launches = dict(sched.stats), k.launch_counts()
            readings[f"{kv_quant}, {name}"] = {
                key: st[key] for key in (
                    "held_ticks", "overlapped_dispatches", "inflight_peak",
                    "decode_dispatches", "mixed_dispatches",
                    "prefill_dispatches", *(f"decode_width_{w}" for w in
                                            sched.core.decode_widths))}
            readings[f"{kv_quant}, {name}"].update(
                sample_slots_launches=launches["sample_slots"],
                sample_calls=sched.core.sample_calls)
            if (launches["sample_slots"] > 0) != (name != "plain_sampler"):
                raise AssertionError(f"{name}: sample_slots launches "
                                     f"{launches['sample_slots']}")
            if name == "defaults" and not (st["held_ticks"]
                                           and st["decode_width_4"]):
                raise AssertionError(f"the defaults never held or ran the "
                                     f"narrow rung: {st}")
            if name == "lagging_device" and not (
                    st["overlapped_dispatches"]
                    and st["inflight_peak"] == ecfg.pipeline_depth == 2):
                raise AssertionError(f"on a lagging device no two dispatches "
                                     f"were in flight: {st}")
        for other in ("plain_sampler", "depth1", "ladder_off",
                      "lagging_device"):
            label = f"kv_quant={kv_quant}, defaults vs {other}"
            reports[label] = _sampled_parity_report(
                params, cfg, reqs, streams["defaults"], streams[other], dev,
                label)
    emit("parity_pipeline", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         lag_ms=LAG_MS, lag_cycles=lag, streams=reports,
         dispatches=readings)


def _request(base, i, text=None, max_tokens=32, chat=None, stream=None,
             temperature=None, top_p=None, model=None, response_format=None,
             stop=None):
    """One request (seed ``i``); by default the i-th of the narrow phase's
    six: chat/completion, streamed or not, temperature 0 / 0.7; ``model``
    the OpenAI model id to send, ``response_format`` its JSON mode,
    ``stop`` its stop strings.
    Returns its status, text, finish reason, usage, the model id it echoed
    and client-side times."""
    chat = i % 2 == 0 if chat is None else chat
    stream = i < 3 if stream is None else stream
    if text is None:
        text = PROMPT_TEXT * (1, 3, 10, 6, 2, 9)[i]     # 144 to 1,440 bytes
    if temperature is None:
        temperature = 0.0 if i % 3 else 0.7
    body = {"max_tokens": max_tokens, "temperature": temperature,
            "seed": i, "stream": stream}
    if top_p is not None:
        body["top_p"] = top_p
    if model is not None:
        body["model"] = model
    if response_format is not None:
        body["response_format"] = response_format
    if stop is not None:
        body["stop"] = stop
    if chat:
        body["messages"] = [{"role": "user", "content": text}]
        url = base + "/v1/chat/completions"
    else:
        body["prompt"] = text
        url = base + "/v1/completions"
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    # first non-empty text delta: random weights may sample ids the byte
    # tokenizer drops, so the server-side TTFT is the one to read
    ttft = None
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        if stream:
            chunks = []
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                if line == "data: [DONE]":
                    chunks.append("[DONE]")
                    break
                c = json.loads(line[len("data: "):])
                if ttft is None and c["choices"][0]["delta"].get("content"):
                    ttft = time.perf_counter() - t0
                chunks.append(c)
            if chunks[-1] != "[DONE]":
                raise AssertionError(f"request {i}: stream without [DONE]")
            final = chunks[-2]
            finish = final["choices"][0]["finish_reason"]
            usage = final.get("usage")
            echoed = sorted({c["model"] for c in chunks[:-1]})
            out = "".join(c["choices"][0]["delta"].get("content", "")
                          for c in chunks[:-1])
        else:
            body = json.loads(resp.read())
            finish = body["choices"][0]["finish_reason"]
            usage = body.get("usage")
            echoed = [body["model"]]
            out = (body["choices"][0]["message"]["content"] if chat
                   else body["choices"][0]["text"])
    return {"i": i, "chat": chat, "stream": stream, "status": status,
            "text": out, "prompt_bytes": len(text), "finish_reason": finish,
            "usage": usage, "model": echoed, "client_first_text_s": ttft,
            "client_latency_s": time.perf_counter() - t0,
            "sent_s": t0}


def draw_8b(dev):
    """Full llama3-8b, bf16, random weights from seed 0 (drawn once)."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


# the narrow path: speculation and the mixed dispatch off, one dispatch in
# flight, no prefill hold, the full batch width
NARROW = dict(spec_decode="off", mixed_phase_dispatch="off",
              pipeline_depth=1, prefill_hold_chunks=0,
              decode_width_ladder="off")


def serving_core(dev, cfg, params, kv_quant="none", batch=8, eos_id=None,
                 **knobs):
    """The serve phases' engine core: ``batch`` slots of 2,048 tokens in
    pages of 128, chunks of 512, over a model-dtype or an int8 pool; the
    reference's defaults (speculation adaptive on, the mixed dispatch
    "auto", on for the card, model-dtype weights) unless ``knobs`` say
    otherwise (``quant="int8"``: int8 weights, quantizing ``params`` in
    place where they are not yet); ``eos_id`` the byte tokenizer's unless
    given."""
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    ecfg = EngineConfig(max_batch_size=batch, max_seq_len=2048,
                        page_size=128, prefill_chunk=512, kv_quant=kv_quant,
                        **knobs)
    return EngineCore(cfg, ecfg, params,
                      ByteTokenizer().eos_id if eos_id is None else eos_id,
                      device=dev)


# the default phases' traffic: 4 requests decode (prompts of 144 to 1,728
# bytes, 10 chunks of 512 in all, 256 tokens each), admitted together once
# all four arrived: more chunks than one grouped prefill takes, into an
# empty batch, so the ramp holds decode; then 2 prompts of 1,296 bytes (3
# chunks of 512) arrive once the first decode dispatch ran (4 slots live:
# no ramp, so they ride mixed dispatches)
DECODERS = (1, 12, 12, 3)
LATE_PROMPT = 9


def _gate_admission(sched):
    """Hold admission until ``open_gate()``: each wave is admitted in one
    pass, however its HTTP requests trickle in."""
    import threading
    admit, gate = sched._admit, threading.Event()
    gate.set()
    sched._admit = lambda: gate.is_set() and admit()
    return gate


def _staggered_traffic(base, sched, submitted, chain=False,
                       decoder_tokens=256, late=2, texts=None, models=None):
    """``serve``'s traffic: the decoders (``decoder_tokens``, greedy and
    0.7 in turn) admitted together, then ``late`` prompts (32 tokens) once
    the first decode dispatch ran. ``chain``: every request at the chain
    server's temperature 0.2 / top-p 0.7 and ``CHAIN_DEVTIME_TOKENS``
    tokens a decoder (``serve_chain``; the late prompts 64).
    ``texts``: (the decoders' prompts, the late prompt) in place of
    ``PROMPT_TEXT`` times ``DECODERS`` and ``LATE_PROMPT``; ``models``: the
    model id request i sends (decoders first), by default none."""
    models = models or [None] * (len(DECODERS) + late)
    if texts is None:
        texts = ([PROMPT_TEXT * n for n in DECODERS],
                 PROMPT_TEXT * LATE_PROMPT)
    gate = _gate_admission(sched)
    gate.clear()
    chain_kw = dict(temperature=0.2, top_p=0.7)
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        futs = [pool.submit(
            _request, base, i, text,
            CHAIN_DEVTIME_TOKENS if chain else decoder_tokens,
            i % 2 == 0, i < 2, model=models[i],
            **(chain_kw if chain else dict(temperature=0.0 if i % 2
                                           else 0.7)))
            for i, text in enumerate(texts[0])]
        _wait_for(lambda: len(submitted) >= len(DECODERS),
                  "the decoders did not arrive")
        gate.set()
        sched._wake.set()
        t0 = time.perf_counter()
        while sched.stats["decode_dispatches"] < 1:
            if time.perf_counter() - t0 > 600:
                raise AssertionError("no decode dispatch within 600 s")
            time.sleep(0.002)
        at = dict(sched.stats)
        futs += [pool.submit(_request, base, 4 + i, texts[1],
                             64 if chain else 32, i == 0, i == 0,
                             model=models[len(DECODERS) + i],
                             **(chain_kw if chain else dict(temperature=0.0)))
                 for i in range(late)]
        return [f.result() for f in futs], at


def _loop_fields(stats, core, warmup_s, launches):
    """What the dispatch loop did in a phase: dispatches per batch-width
    rung, the held ticks, dispatches issued with another in flight and the
    most left in flight, the warmup's seconds, the sampler's launches and
    the engine's sampling calls, and the first tokens streamed between a
    dispatch's steps."""
    return dict(
        pipeline_depth=core.cfg.pipeline_depth,
        prefill_hold_chunks=core.cfg.prefill_hold_chunks,
        decode_widths=list(core.decode_widths),
        dispatches_by_width={w: stats[f"decode_width_{w}"]
                             for w in core.decode_widths},
        held_ticks=stats["held_ticks"],
        overlapped_dispatches=stats["overlapped_dispatches"],
        inflight_peak=stats["inflight_peak"], warmup_s=warmup_s,
        sample_slots_launches=launches["sample_slots"],
        sample_calls=core.sample_calls,
        first_mid_dispatch=stats["first_mid_dispatch"])


def _check_loop(name, stats, core, launches, sampled, ramp):
    """A serve phase at the new defaults fails if its designed ramp never
    held, if the narrow rung never ran, if a sampled request drew without
    the kernel, or if the sampler's launches differ from the engine's
    sampling calls (one launch a call). Dispatches issued with another in flight are
    reported, not required: at llama3-8b bf16 the eager host issues a
    dispatch for longer than the card computes it, so each result has
    landed before the host looks (``parity_pipeline``'s lagging device
    holds two in flight)."""
    narrow = min(core.decode_widths)
    faults = []
    if ramp and stats["held_ticks"] < 1:
        faults.append("the ramp never held decode")
    if narrow < core.batch and stats[f"decode_width_{narrow}"] < 1:
        faults.append(f"the narrow rung {narrow} never ran")
    if sampled and launches["sample_slots"] < 1:
        faults.append("sampled requests drew without sample_slots")
    if launches["sample_slots"] != core.sample_calls:
        faults.append(f"{launches['sample_slots']} sample_slots launches "
                      f"for {core.sample_calls} sampling calls")
    if faults:
        raise AssertionError(f"{name}: {'; '.join(faults)}: {stats}, "
                             f"launches {launches}")


class _ForwardCount:
    """While entered: the model's forward passes (``llama.run_blocks``
    calls), unembeddings (``llama._unembed`` calls), the ragged kernel's
    launches whose rows pass ``QG_MAX`` query vectors (query tiles), and
    every ``F.linear`` call (none may multiply a weight on an int8 path)."""

    def __enter__(self):
        import torch.nn.functional as F
        from generativeaiexamples_tpu_torch.models import llama
        from generativeaiexamples_tpu_torch.ops.cuda import attention as k
        self.blocks = self.unembeds = self.tiled = self.linear = 0
        self._saved = [(llama, "run_blocks", llama.run_blocks),
                       (llama, "_unembed", llama._unembed),
                       (k, "ragged_paged_attention",
                        k.ragged_paged_attention),
                       (F, "linear", F.linear)]
        blocks, unembed, ragged, linear = (f for _, _, f in self._saved)

        def run_blocks(*args, **kw):
            self.blocks += 1
            return blocks(*args, **kw)

        def _unembed(*args, **kw):
            self.unembeds += 1
            return unembed(*args, **kw)

        def ragged_paged_attention(q, k_pages, *args, **kw):
            Qb, H, HD = q.shape[1], q.shape[2], q.shape[3]
            G = H // (k_pages.shape[-1] // HD)
            cap = k.qg_max(HD) if hasattr(k, "qg_max") else k.QG_MAX
            self.tiled += Qb * G > cap
            return ragged(q, k_pages, *args, **kw)

        def counted_linear(*args, **kw):
            self.linear += 1
            return linear(*args, **kw)

        llama.run_blocks, llama._unembed = run_blocks, _unembed
        k.ragged_paged_attention = ragged_paged_attention
        F.linear = counted_linear
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


# serve_gemma's JSON-mode request: the grammar mask and the sampler's
# mask and advance at the model's vocabulary
JSON_PROMPT = "Describe the paged KV cache as a JSON object."


# Scheduler.stats keys and the registry counter that moves with each (the
# reference's names); host_fetches is engine_host_fetches_total there
STAT_METRICS = (("prefill_chunks", "prefill_chunks"),
                ("decode_steps", "decode_steps"),
                ("mixed_dispatches", "mixed_dispatches"),
                ("spec_bonus_tokens", "spec_bonus_tokens"),
                ("spec_base_steps", "spec_base_steps"),
                ("preemptions", "preemptions"),
                ("prefix_hit_tokens", "prefix_hit_tokens"),
                ("prefix_prompt_tokens", "prefix_prompt_tokens"),
                ("admission_skips", "admission_skips"),
                ("host_fetches", "engine_host_fetches_total"),
                ("kv_handoff_imports", "kv_handoff_imports"),
                ("kv_handoff_exports", "kv_handoff_exports"),
                ("snapshot_resumes", "snapshot_resumes"),
                ("spill_resumes", "spill_resumes"))
TIMELINE_PHASES = ("queued", "admitted", "prefill_start", "first_token",
                   "finished")


def _get_json(url, headers=None, want=200):
    """GET ``url`` as JSON; fails unless it answers ``want``."""
    status, _, raw = _get(url, headers or {})
    if status != want:
        raise AssertionError(f"GET {url} answered {status}, not {want}: "
                             f"{raw[:300]!r}")
    return json.loads(raw)


def _scrape(base, fmt):
    """``/metrics?format=<fmt>`` parsed: {series: value}, and the text."""
    status, headers, raw = _get(f"{base}/metrics?format={fmt}", {})
    if status != 200 or not headers.get("Content-Type", "").startswith(
            "text/plain" if fmt == "prometheus"
            else "application/openmetrics-text"):
        raise AssertionError(f"/metrics?format={fmt}: {status} "
                             f"{headers.get('Content-Type')}")
    text = raw.decode()
    series = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            series[name.split(" # ")[0]] = float(value)
    return series, text


def _plane_checks(base, stats, scrape0, reqs):
    """``serve``'s host-plane checks after its traffic, on the live
    server: each scheduler counter's change over the window in the
    Prometheus and the OpenMetrics scrape equals its ``Scheduler.stats``
    key (zeroed at the window's start); every request's
    ``/debug/requests/<id>`` timeline holds its phases in order;
    ``/debug/flight`` holds samples; ``/health`` carries the perf card and
    the tenant rollup; ``engine_recompiles_total`` and the first-seen keys
    (``/debug/compiles``) are reported."""
    prom, _ = _scrape(base, "prometheus")
    om, om_text = _scrape(base, "openmetrics")
    if not om_text.rstrip().endswith("# EOF"):
        raise AssertionError("the OpenMetrics scrape has no # EOF")
    counters, faults = {}, []
    for key, metric in STAT_METRICS:
        moved = prom.get(metric, 0.0) - scrape0.get(metric, 0.0)
        moved_om = om.get(metric, 0.0) - scrape0.get(metric, 0.0)
        counters[metric] = moved
        if not moved == moved_om == stats.get(key, 0):
            faults.append(f"{metric} moved {moved} / {moved_om}, "
                          f"stats[{key!r}] {stats.get(key, 0)}")
    if faults:
        raise AssertionError(f"serve: the scrape disagrees with "
                             f"Scheduler.stats: {faults}")
    timelines = []
    for req in reqs:
        rec = _get_json(f"{base}/debug/requests/{req.request_id}")
        stamps = [rec["phases"].get(p) for p in TIMELINE_PHASES]
        if None in stamps or stamps != sorted(stamps):
            raise AssertionError(f"timeline of {req.request_id} out of "
                                 f"order or incomplete: {rec['phases']}")
        timelines.append(rec["durations_s"])
    flight = _get_json(f"{base}/debug/flight?window=600")
    if not flight["samples"]:
        raise AssertionError("/debug/flight holds no sample")
    health = _get_json(f"{base}/health")
    for key in ("perf", "usage_by_tenant", "slo_pressure"):
        if key not in health:
            raise AssertionError(f"/health has no {key}: {sorted(health)}")
    compiles = _get_json(f"{base}/debug/compiles")
    first_seen = [f"{e['program']}/{e['bucket']}" for e in compiles["events"]
                  if e["during_serving"]]
    requests_total = {k: v - scrape0.get(k, 0.0) for k, v in prom.items()
                      if k.startswith("requests_finished")}
    return dict(counters_equal_stats=counters,
                requests_finished=requests_total,
                timelines=len(timelines),
                ttft_s_by_timeline=sorted(t.get("ttft_s", -1.0)
                                          for t in timelines),
                flight_samples=len(flight["samples"]),
                flight_last=flight["samples"][-1],
                perf_card=health["perf"],
                usage_by_tenant=health["usage_by_tenant"],
                slo_pressure=health["slo_pressure"],
                recompiles=prom.get("engine_recompiles_total", 0.0)
                - scrape0.get("engine_recompiles_total", 0.0),
                first_seen_mid_serving=first_seen,
                metric_series=len(prom))


# serve_chain's ledger readings, for the comparison with profile's
LEDGER = {}
# serve_chain's decoders' tokens: dispatches enough for APP_DEVTIME_SAMPLE_N
# = 16 to time a few of them
CHAIN_DEVTIME_TOKENS = 384


def _devtime_vs_profile(prof):
    """The ledger's device ms a decode step (serve_chain, sampled timing
    events: each timed dispatch's span on the stream) beside ``profile``'s
    device ms a step (kernel time under torch.profiler, the narrow step);
    the ratio is reported, a gap is explained in PERF.md."""
    led = LEDGER.get("serve_chain") or {}
    per_step = led.get("decode_device_ms_per_step")
    emit("devtime_vs_profile", ledger_ms_per_step=per_step,
         profile_device_ms_per_step=prof["device_ms_per_step"],
         profile_wall_ms_per_step=prof.get("decode_ms_per_step"),
         ratio=(per_step / prof["device_ms_per_step"]
                if per_step and prof["device_ms_per_step"] else None),
         timed_decode_steps=led.get("timed_decode_steps"))


def _devtime_readings(base):
    """``serve_chain``'s ledger under ``APP_DEVTIME=sample``: per key its
    count, timed dispatches, device and queue seconds, tokens and
    padding; the live MFU and HBM-read gauges; the device ms a decode step
    of the timed decode dispatches (each key's steps from its bucket)."""
    snap = _get_json(f"{base}/debug/devtime")
    if snap["mode"] != "sample" or not snap["totals"]["timed"]:
        raise AssertionError(f"/debug/devtime timed nothing: {snap['mode']} "
                             f"{snap['totals']}")
    rows = {}
    step_s, steps = 0.0, 0
    for r in snap["programs"]:
        rows[f"{r['program']}/{r['bucket']}"] = {
            k: r.get(k) for k in ("count", "timed", "device_s", "queue_s",
                                  "issue_s", "tokens", "padded_tokens",
                                  "row_util", "est_device_s",
                                  "steady_p50_s")}
        if r["program"].startswith("decode") and r["timed"]:
            k = int(r["bucket"][1:].split("w")[0].split("b")[0]
                    .split("m")[0])
            step_s += r["device_s"]
            steps += r["timed"] * k
    prom, _ = _scrape(base, "prometheus")
    mfu = {k: v for k, v in prom.items() if k.startswith("engine_mfu")}
    return dict(mode=snap["mode"], sample_n=snap["sample_n"],
                totals=snap["totals"], programs=rows,
                padding_waste_frac=snap["padding_waste_frac"],
                engine_mfu=mfu,
                engine_hbm_read_util=prom.get("engine_hbm_read_util"),
                perf_model=snap.get("perf_model"),
                decode_device_ms_per_step=(1e3 * step_s / steps
                                           if steps else None),
                timed_decode_steps=steps)



def phase_serve(dev, cfg, params, kv_quant="none", narrow=False,
                chain=False, quant="none", model="llama3-8b",
                decoder_tokens=256, late=2, tok=None, texts=None, name=None,
                adapters=None, adapter_traffic=True, json_request=False,
                planes=False, devtime=None):
    """HTTP requests against a full model (llama3-8b unless ``model`` says
    otherwise); the launch counts, the dispatch counts and the engine's
    sampling calls are set to 0 just before the requests and read just
    after. ``narrow``: speculation and the mixed dispatch off, six
    concurrent requests (the narrow path); else the reference's defaults
    and the staggered traffic (``decoder_tokens`` a decoder, ``late``
    late prompts), which must run at least one mixed dispatch and one
    widened step; ``chain``: that traffic at the chain server's
    temperature 0.2 / top-p 0.7 (``serve_chain``), every step through the
    top-p bisection. ``quant="int8"``: int8 weights (``params`` are
    quantized in place if they are not yet), every projection and the
    head through ``w8a16_gemm`` (7 launches a layer and one a head per
    forward pass, no ``F.linear``). ``tok``: a checkpoint's tokenizer in
    place of the byte tokenizer (its ``eos_id`` too), ``texts`` the
    staggered traffic's prompts in its tokens, ``name`` the phase's line.
    ``adapters``: name -> adapter tree, registered before ``warmup``
    (``serve_lora``): the requests name the base model and each adapter
    in turn, every reply must echo its id, no mixed dispatch may run (the
    engine turns it off), ``lora`` launches once a group of targets that
    share an input and a layer in each forward pass with an adapter row
    (``core.lora_passes``), and ``_lora_serve_checks`` runs once the
    traffic is done; ``adapter_traffic=False``: the adapters stay resident
    but every request names the base model (``serve_lora_base``: the
    mixed dispatch's absence without the adapter rows' work, and no
    ``lora`` launch at all). Without adapters no ``lora`` launch at all.
    ``json_request``: once the traffic is done, one more chat request with
    ``response_format: json_object`` (greedy, 64 tokens) inside the
    counted window: its reply must parse as JSON, and ``grammar_mask`` and
    the sampler's masked variants must launch. ``planes``: the host-plane
    checks of ``_plane_checks`` after the traffic (``serve``), with the
    device-time ledger reset before warmup so the first-seen keys are this
    engine's. ``devtime``: the ledger's mode for the phase
    (``serve_chain``: "sample", every 16th dispatch timed), read back by
    ``_devtime_readings`` and set off again after. Returns (launches, the
    engine core)."""
    import torch
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    from generativeaiexamples_tpu_torch.ops.cuda import build

    weights = ("random, torch.Generator seed 0" if tok is None else
               "random, torch.Generator seed 0, loaded from safetensors")
    tok = tok or ByteTokenizer()
    if planes or devtime:
        # this engine's warmup marks its own keys; serving marks them hot
        DEVTIME.reset()
    if devtime:
        os.environ["APP_DEVTIME"] = devtime
        os.environ["APP_DEVTIME_SAMPLE_N"] = "16"
        DEVTIME.configure(sample_n=16)
    try:
        core = serving_core(dev, cfg, params, kv_quant, quant=quant,
                            eos_id=tok.eos_id, **(NARROW if narrow else {}))
    finally:
        os.environ.pop("APP_DEVTIME", None)
        os.environ.pop("APP_DEVTIME_SAMPLE_N", None)
    base_id = f"{model}-random"
    models, register_s = None, None
    if adapters:
        t0 = time.perf_counter()
        for ad_name, tree in adapters.items():
            core.register_adapter(ad_name, tree)
        torch.cuda.synchronize()
        register_s = time.perf_counter() - t0
        ids = [base_id] + (list(adapters) if adapter_traffic else [])
        models = [ids[i % len(ids)] for i in range(len(DECODERS) + late)]
    warmup_s = core.warmup()
    sched = Scheduler(core, tok)
    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)

    sched.submit = recording_submit
    # an earlier phase's engine core lives on in a reference cycle (its
    # grammar stack holds a bound method of it) until the collector runs:
    # collect first, so the peak reads this phase's tensors only
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    httpd, thread = serve_in_thread(sched, base_id)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    at_late = None
    lora_checks = None
    plane_readings = devtime_readings = None
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            if resp.status != 200:
                raise AssertionError("/health did not answer 200")
            health = json.loads(resp.read())
        with _ForwardCount() as fwd:
            k.reset_launch_counts()
            for key in sched.stats:
                sched.stats[key] = 0
            core.sample_calls = 0
            lora_passes0 = core.lora_passes
            scrape0 = _scrape(base, "prometheus")[0] if planes else None
            t0 = time.perf_counter()
            if narrow:
                with concurrent.futures.ThreadPoolExecutor(6) as pool:
                    results = list(pool.map(lambda i: _request(base, i),
                                            range(6)))
            else:
                results, at_late = _staggered_traffic(
                    base, sched, submitted, chain, decoder_tokens, late,
                    texts, models)
            if json_request:
                results.append(_request(
                    base, len(results), JSON_PROMPT, 64, chat=True,
                    stream=False, temperature=0.0,
                    response_format={"type": "json_object"}))
            wall = time.perf_counter() - t0
            launches = k.launch_counts()
            variants = build.sampler_launches_by_variant()
            lora_passes = core.lora_passes - lora_passes0
            gemm_rows = build.gemm_launches_by_rows()
            stats = dict(sched.stats)
        traffic = list(submitted)     # the counted window's requests
        if planes:
            plane_readings = _plane_checks(base, stats, scrape0, traffic)
        if devtime:
            devtime_readings = _devtime_readings(base)
            LEDGER[name or "serve_chain"] = devtime_readings
        if adapters and adapter_traffic:
            calls = core.sample_calls
            lora_checks = _lora_serve_checks(base, submitted, base_id,
                                             list(adapters))
            core.sample_calls = calls   # the checks below read the window
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=30)
        if devtime:
            DEVTIME.configure(mode="off")
    json_reply = None
    if json_request:
        text = results[-1]["text"]
        try:
            value = json.loads(text)
        except ValueError as exc:
            raise AssertionError(f"{name or model}: the json_object reply "
                                 f"{text!r} does not parse: {exc}")
        masked = sum(n for v, n in variants.items() if "mask" in v)
        json_reply = dict(status=results[-1]["status"],
                          finish_reason=results[-1]["finish_reason"],
                          text_bytes=len(text.encode()),
                          value_type=type(value).__name__,
                          grammar_mask_launches=launches["grammar_mask"],
                          sampler_variants=variants)
        if launches["grammar_mask"] < 1 or masked < 1:
            raise AssertionError(f"the json_object request ran without the "
                                 f"grammar mask: {json_reply}")
    for i, r in enumerate(results):
        r["sent_s"] -= t0
        del r["text"]         # random weights: the text is noise
        if r["status"] != 200 or not r["finish_reason"] or not r["usage"]:
            raise AssertionError(f"request failed: {r}")
        if r["model"] != [models[i] if models else base_id]:
            raise AssertionError(f"request {i} echoed {r['model']}, not "
                                 f"{models[i] if models else base_id}")
    server_ttft = sorted(round(r.first_token_at - r.submitted_at, 4)
                         for r in traffic if r.first_token_at)
    if len(server_ttft) != len(results) or any(r.error for r in traffic):
        raise AssertionError("a request got no first token or failed: "
                             f"{[r.error for r in traffic]}")
    L = cfg.n_layers
    decode_key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                  else "ragged_paged_attention")
    need_flash = L * stats["prefill_dispatches"]
    need_decode = L * stats["decode_steps"]
    if (launches["flash_prefill"] < need_flash or need_flash == 0
            or launches[decode_key] < need_decode or need_decode == 0):
        raise AssertionError(f"serving did not run through the kernels: "
                             f"launches {launches}, dispatches {stats}")
    # every projection (7 a layer) and every unembedding through the W8A16
    # kernel, and no F.linear at all, with int8 weights
    need_gemm = 7 * L * fwd.blocks + fwd.unembeds if quant == "int8" else 0
    if launches["w8a16_gemm"] != need_gemm or (
            quant == "int8" and (need_gemm == 0 or fwd.linear)):
        raise AssertionError(
            f"{launches['w8a16_gemm']} w8a16_gemm launches for "
            f"{fwd.blocks} forward passes and {fwd.unembeds} "
            f"unembeddings (want {need_gemm}), {fwd.linear} F.linear calls")
    if sum(gemm_rows.values()) != need_gemm:
        raise AssertionError(f"w8a16_gemm launches by rows {gemm_rows} do "
                             f"not add up to {need_gemm}")
    # the update once a group of targets that share an input and a layer
    # in each forward pass that had an adapter row (counted by the engine),
    # and never in another: base traffic with adapters resident makes none
    targets = len(next(iter(adapters.values()))) if adapters else 0
    need_lora = core.lora_groups * L * lora_passes
    if (launches["lora"] != need_lora or lora_passes > fwd.blocks
            or (adapters and adapter_traffic and need_lora == 0)
            or (not adapter_traffic and launches["lora"])):
        raise AssertionError(f"{launches['lora']} lora launches for "
                             f"{lora_passes} of {fwd.blocks} forward passes "
                             f"with adapter rows (want {need_lora})")
    if adapters and (stats["mixed_dispatches"] or stats["spec_steps"] < 1):
        raise AssertionError(f"with adapters resident: a mixed dispatch "
                             f"ran or no widened step did: {stats}")
    if not narrow and not adapters and (stats["mixed_dispatches"] < 1
                                        or stats["spec_steps"] < 1):
        raise AssertionError(f"the default path ran no mixed dispatch or "
                             f"no widened step: {stats}")
    want_widths = [1] if narrow else [2, 3, 5, 9]
    if (health.get("kv_dtype") != ("int8" if kv_quant == "int8"
                                   else cfg.dtype)
            or health.get("spec_widths") != want_widths
            or health.get("mixed") != (not narrow and not adapters)
            or health.get("inflight_dispatches") != 0
            or health.get("pipeline_depth") != core.cfg.pipeline_depth
            or health.get("quant") != quant
            or health.get("weight_bytes") != core.param_bytes):
        raise AssertionError(f"/health reports {health}")
    name = name or ("serve_70b_w8" if model == "llama3-70b" else
                    "serve" + ("_two_dispatch" if narrow else "")
                    + ("_chain" if chain else "")
                    + ("" if kv_quant == "none" else "_" + kv_quant)
                    + ("_w8" if quant == "int8" else ""))
    if not narrow:
        _check_loop(name, stats, core, launches, sampled=True, ramp=True)
    gen = sum(r["usage"]["completion_tokens"] for r in results)
    fields = dict(
        model=model, n_layers=L, dtype=cfg.dtype, kv_quant=kv_quant,
        quant=quant, weight_bytes=health["weight_bytes"],
        spec_widths=health["spec_widths"], mixed=health["mixed"],
        weights=weights, tokenizer=type(tok).__name__, requests=results,
        prompt_tokens=[len(r.prompt_ids) for r in traffic],
        server_ttft_s=server_ttft, completion_tokens=gen, wall_s=wall,
        gen_tok_s=gen / wall, dispatches=stats, launches=launches,
        forward_passes=fwd.blocks, unembeddings=fwd.unembeds,
        query_tiled_ragged_launches=fwd.tiled,
        stats_when_late_prompts_sent=at_late,
        sampling=("temperature 0.2, top_p 0.7, seeds 0-5" if chain else
                  "greedy and temperature 0.7 in turn"),
        spec_accepted_share_of_ceiling=(
            stats["spec_bonus_tokens"]
            / max(1, stats["spec_base_steps"] * (core.spec_width - 1))),
        spec_bonus_per_slot_step=(stats["spec_bonus_tokens"]
                                  / max(1, stats["spec_base_steps"])),
        kv_pool_bytes=health["kv_pool_bytes"],
        multi_chunk_prompt=max(len(r.prompt_ids) for r in traffic) > 512,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        **_loop_fields(stats, core, warmup_s, launches),
        **(dict(gemm_launches_by_rows=gemm_rows) if quant == "int8" else {}),
        **(dict(json_object_reply=json_reply) if json_request else {}),
        **(dict(planes=plane_readings) if planes else {}),
        **(dict(devtime=devtime_readings) if devtime else {}),
        **(dict(adapters=list(adapters), adapter_targets=targets,
                adapter_rank=int(next(iter(next(iter(
                    adapters.values())).values()))["a"].shape[1]),
                models_sent=models, register_s=register_s,
                lora_groups_a_layer=core.lora_groups,
                lora_passes=lora_passes,
                lora_checks=lora_checks) if adapters else {}))
    if model == "llama3-70b" and fwd.tiled < 1:
        raise AssertionError(f"{name}: no ragged launch of more than "
                             f"{k.QG_MAX} query vectors a row")
    emit(name, **fields)
    return launches, core


def phase_serve_70b(dev):
    """llama3-70b at full width and depth (80 layers, 64/8 heads, hidden
    28,672) on one card: int8 weights drawn from seed 0 and quantized one
    matrix at a time as drawn, an int8 KV pool, the engine's defaults (8
    slots of 2,048, the width ladder, speculation up to W = 9, the mixed
    dispatch "auto" -> on). Traffic: ``serve``'s 4 decoders at 32 tokens
    admitted together, then 1 prompt of 1,296 bytes once the first decode
    dispatch ran (4 live slots: not a ramp, so it rides mixed dispatches,
    whose rows of 16 queries hold 128 query vectors: two query tiles).
    Every request 200, a mixed dispatch, query-tiled ragged launches,
    every projection through ``w8a16_gemm``. Returns the launches."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama3_70b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev, quant="int8")
    torch.cuda.synchronize()
    emit("weights_70b", model="llama3-70b", quant="int8",
         init_weights_s=time.perf_counter() - t0,
         allocated_gb=torch.cuda.memory_allocated() / 1e9,
         peak_during_init_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches, core = phase_serve(dev, cfg, params, "int8", quant="int8",
                                 model="llama3-70b", decoder_tokens=32,
                                 late=1)
    del core, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The Gemma family: heads of 256, a vocabulary of 256,000
# ---------------------------------------------------------------------------

GEMMA_PARITY = ("gemma-7b", "gemma-2b")


def _gemma_parity_model(dev, name):
    """``name``'s widths at 2 layers, f32, seeded random weights with every
    norm weight drawn off one (so the norms and the (1 + w) layout
    matter)."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.models import llama, model_config
    cfg = dataclasses.replace(model_config(name), n_layers=2,
                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(5)
    params = llama.init_params(g, cfg, device=dev)
    for norm in [params["final_norm"]] + [
            layer[key] for layer in params["layers"]
            for key in ("attn_norm", "mlp_norm")]:
        norm.add_(0.2 * torch.randn(norm.shape, generator=g, device=dev))
    return cfg, params


def _f32_hd256_checks(dev):
    """The f32 head_dim 256 instances the parity phase runs, held to their
    plain versions directly (at Gemma's widths with random weights the
    sqrt(dim)-scaled embedding dominates the residual stream, so greedy
    streams and logits barely read attention): ``flash_prefill`` over two
    chunks of 512 (a prompt's first and a 300-token second chunk against
    a T = 2048 view), ``ragged_paged_attention`` over an f32 and an int8
    pool, decode rows at batch 8 and verify rows of 5, and
    ``ragged_decode`` at batch 8, at gemma-7b's and gemma-2b's heads;
    each within 1e-4 of its largest plain output (f32, another summation
    order; flash_prefill over its valid query rows). Raises
    KernelMismatch."""
    import torch
    from generativeaiexamples_tpu_torch.ops.attention import mha_decode
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    g = torch.Generator(device=dev).manual_seed(17)
    ps, maxp, T = 128, 16, 2048
    out = {}

    def check(name, got, want):
        err = (got - want).abs().max().item()
        limit = 1e-4 * max(1.0, want.abs().max().item())
        out[name] = err
        if not (err <= limit and bool(torch.isfinite(got).all())):
            raise KernelMismatch("parity_gemma", {"case": name,
                                                  "max_abs_err": err,
                                                  "limit": limit})

    for m, (H, KV, HD) in (("gemma7b", GEMMA_7B_HEADS),
                           ("gemma2b", GEMMA_2B_HEADS)):
        q = torch.randn((2, 512, H, HD), generator=g, device=dev)
        kc, vc = (torch.randn((2, T, KV, HD), generator=g, device=dev)
                  for _ in range(2))
        sp = torch.tensor([0, 512], dtype=torch.int32, device=dev)
        vt = torch.tensor([512, 812], dtype=torch.int32, device=dev)
        valid = torch.arange(512, device=dev)[None] < (vt - sp)[:, None]
        check(f"{m}_flash_prefill",
              k.flash_prefill(q, kc, vc, sp, vt)[valid],
              k.flash_prefill_plain(q, kc, vc, sp, vt)[valid])
        del q, kc, vc
        P = 8 * maxp + 1
        shape = (2 * P, ps, KV * HD)
        tables = (torch.randperm(P - 1, generator=g, device=dev)[:8 * maxp]
                  + 1).reshape(8, maxp).to(torch.int32)
        for W in (1, 5):
            lens = torch.tensor([max(n, W) for n in DECODE_LENS],
                                dtype=torch.int32, device=dev)
            qn = torch.full((8,), W, dtype=torch.int32, device=dev)
            q = torch.randn((8, W, H, HD), generator=g, device=dev)
            for pool in ("f32", "int8"):
                if pool == "f32":
                    kp, vp = (torch.randn(shape, generator=g, device=dev)
                              for _ in range(2))
                    ks = vs = None
                else:
                    kp, vp = (torch.randint(-127, 128, shape, generator=g,
                                            device=dev, dtype=torch.int8)
                              for _ in range(2))
                    ks, vs = (torch.rand((2 * P, KV, ps), generator=g,
                                         device=dev) * 0.01 + 0.01
                              for _ in range(2))
                args = (q, kp, vp, tables, lens, lens - qn, qn)
                check(f"{m}_ragged_{pool}_qb{W}",
                      k.ragged_paged_attention(*args, layer=1,
                                               pages_per_layer=P,
                                               k_scales=ks, v_scales=vs),
                      k.ragged_paged_attention_plain(*args, 1, P, ks, vs))
        kc, vc = (torch.randn((8, T, KV, HD), generator=g, device=dev)
                  for _ in range(2))
        q = torch.randn((8, 1, H, HD), generator=g, device=dev)
        lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
        check(f"{m}_ragged_decode", k.ragged_decode(q, kc, vc, lens),
              mha_decode(q, kc, vc, lens))
    return out


def phase_parity_gemma(dev):
    """gemma-7b's widths (16 heads and 16 KV heads of 256, dim 3,072, GeGLU
    hidden 24,576) and gemma-2b's (8 heads on one KV head of 256, dim
    2,048), 2 layers, f32, V = 256,000: the kernel path (the head_dim 256
    f32 instances of ``flash_prefill`` and ``ragged_paged_attention``,
    ``sample_slots`` at V = 256,000) against the plain path. The logits of
    a dense-API prefill of a 726-token prompt, kernel attention against
    plain attention, within ``PARITY_GAP_TOL`` of each other; then greedy
    streams through the engine over a model-dtype pool and an int8 pool
    with speculation and the mixed dispatch on (a prompt arriving while
    the first decodes, no prefill hold), token for token
    (``_parity_report``): gemma-2b's verify and mixed rows run as query
    tiles. First the f32 instances themselves (``_f32_hd256_checks``).
    Raises KernelMismatch on a kernel or the logits, AssertionError on a
    stream."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    f32_errors = _f32_hd256_checks(dev)
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    prompts = [tok.encode(PROMPT_TEXT * 2, add_bos=True),
               tok.encode(PROMPT_TEXT * 5, add_bos=True)]   # two chunks
    out = {}
    for name in GEMMA_PARITY:
        cfg, params = _gemma_parity_model(dev, name)
        ids = torch.tensor([prompts[1]], device=dev)
        seq = torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev)
        logits = {}
        with torch.no_grad():
            for attn in ("kernel", "plain"):
                k.reset_launch_counts()
                acfg = dataclasses.replace(cfg, attn_impl=attn)
                logits[attn], _ = llama.prefill(
                    params, acfg, ids, llama.KVCache.create(acfg, 1, 1024,
                                                            device=dev),
                    torch.zeros_like(seq), seq)
                if (attn == "kernel") != (k.launch_counts()["flash_prefill"]
                                          == cfg.n_layers):
                    raise AssertionError(f"parity_gemma {name}: "
                                         f"{attn} forward launched "
                                         f"{k.launch_counts()}")
        err = (logits["kernel"] - logits["plain"]).abs().max().item()
        if not (err <= PARITY_GAP_TOL
                and bool(torch.isfinite(logits["kernel"]).all())):
            raise KernelMismatch("parity_gemma", {
                "model": name, "logits_max_abs_err": err,
                "limit": PARITY_GAP_TOL})
        streams, reports, dispatches = {}, {}, {}
        for kv_quant in ("none", "int8"):
            key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                   else "ragged_paged_attention")
            for attn in ("kernel", "plain"):
                ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048,
                                    page_size=128, prefill_chunk=512,
                                    dtype="float32", attention=attn,
                                    kv_quant=kv_quant, prefill_hold_chunks=0)
                sched = Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id,
                                             device=dev), tok)
                k.reset_launch_counts()
                sched.start()
                try:
                    streams[attn] = _staggered_streams(sched, prompts, 96,
                                                       24)
                finally:
                    sched.stop()
                launches = k.launch_counts()
                if attn == "kernel" and not (launches["flash_prefill"]
                                             and launches[key]
                                             and launches["sample_slots"]):
                    raise AssertionError(f"parity_gemma {name} "
                                         f"({kv_quant}) did not launch "
                                         f"the kernels: {launches}")
                if not (sched.stats["mixed_dispatches"]
                        and sched.stats["spec_steps"]):
                    raise AssertionError(f"parity_gemma {name} ({kv_quant},"
                                         f" {attn}) ran no mixed or widened "
                                         f"step: {sched.stats}")
                dispatches[f"{kv_quant}, {attn}"] = dict(
                    mixed=sched.stats["mixed_dispatches"],
                    spec_steps=sched.stats["spec_steps"], launches=launches)
            label = f"{name}, kv_quant={kv_quant}, kernel vs plain"
            reports[label] = _parity_report(params, cfg, prompts,
                                            streams["kernel"],
                                            streams["plain"], dev, label)
        out[name] = dict(logits_max_abs_err=err, streams=reports,
                         dispatches=dispatches,
                         widths=dict(dim=cfg.dim, heads=cfg.n_heads,
                                     kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim,
                                     hidden=cfg.hidden_dim,
                                     vocab=cfg.vocab_size))
        del params, logits
        torch.cuda.empty_cache()
    emit("parity_gemma", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         logits_tolerance=f"{PARITY_GAP_TOL} absolute", n_layers=2,
         dtype="float32", f32_kernel_max_abs_err=f32_errors,
         f32_kernel_tolerance="1e-4 x max(1, the largest plain output)",
         models=out)
    return out


def parity_gemma_cases(dev):
    """``phase_parity_gemma`` as one check-only case (the planted faults
    read it): a failed check of any kind is its reading."""
    def case():
        try:
            phase_parity_gemma(dev)
        except KernelMismatch:
            raise
        except AssertionError as exc:
            raise KernelMismatch("parity_gemma", {"error": str(exc)[:400]})
        return {"passed": True}
    return {"streams": case}



# ---------------------------------------------------------------------------
# The rest of the model block: the top-k MoE (mixtral-8x7b) and StarCoder2's
# LayerNorm, biases and plain MLP
# ---------------------------------------------------------------------------

# moe_mlp on the card against the CPU on the same f32 inputs: another
# summation order, so within this share of the largest CPU output
MOE_TOL = 1e-4
# (case, tokens, capacity factor or None for the config's): a prefill
# chunk's worth of tokens, the same under a capacity that drops, a decode
# batch
MOE_CASES = (("rows128", 128, None), ("rows128_drops", 128, 0.5),
             ("rows8", 8, None))
MOE_STAGES = ("route", "dispatch", "experts", "combine")
SERVE_MOE_LAYERS = 8
# a divergence of the kernel path's MoE streams from the plain path's is
# accepted only where the first token routed apart had a router margin
# (k-th minus (k+1)-th probability) below this in the plain run: top-k
# routing is discontinuous, so attention's f32 rounding can flip a choice
# there and move the output by a whole expert's difference
ROUTER_NEAR_TIE = 1e-5


class _RoutingLog:
    """While entered: every ``ops.moe.route`` call's choices, valid
    tokens and router margins, copied to the host, in call order (a
    forward pass's layers in turn)."""

    def __enter__(self):
        from generativeaiexamples_tpu_torch.ops import moe
        self.calls, self._moe, self._route = [], moe, moe.route

        def route(x, w_router, k, C, valid=None):
            r = self._route(x, w_router, k, C, valid)
            top = r.probs.topk(k + 1, dim=-1).values
            self.calls.append((
                r.expert_ix.cpu(),
                None if valid is None else valid.cpu(),
                (top[:, k - 1] - top[:, k]).cpu()))
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def _first_routing_split(kernel, plain):
    """The first route call where the kernel run's log and the plain
    run's choose apart for a valid token: (call index, the smallest router
    margin of those tokens in the plain run), or None where they never
    do."""
    for i, ((ix_k, vk, _), (ix_p, vp, mp)) in enumerate(zip(kernel, plain)):
        if ix_k.shape != ix_p.shape:
            return i, 0.0
        apart = (ix_k != ix_p).any(-1)
        if vp is not None:
            apart &= vk.reshape(-1) & vp.reshape(-1)
        if apart.any():
            return i, mp[apart].min().item()
    return None


def _moe_parity_report(params, cfg, prompts, got, want, logs, dev, label):
    """``_parity_report`` for an MoE model's kernel and plain streams, run
    through one deterministic schedule: equal, or diverging only where the
    runs first routed a token apart at a plain-run router margin below
    ``ROUTER_NEAR_TIE`` (``logs``: the kernel run's and the plain run's
    ``_RoutingLog`` calls), or,
    with no routing split, at a near-tie of the plain logits."""
    if got == want:
        return [{"prompt": i, "identical": True, "tokens": len(a)}
                for i, a in enumerate(got)]
    split = _first_routing_split(*logs)
    if split is None:
        return _parity_report(params, cfg, prompts, got, want, dev, label)
    call, margin = split
    report = [{"prompt": i, "identical": a == b, "tokens": len(a),
               "routing_split_call": call,
               "routing_split_layer": call % cfg.n_layers,
               "routing_split_margin": margin}
              for i, (a, b) in enumerate(zip(got, want))]
    if margin >= ROUTER_NEAR_TIE:
        emit("parity_moe", ok=False, path=label, streams=report)
        raise AssertionError(f"{label}: the kernel and plain runs route a "
                             f"token apart at a router margin of {margin}")
    return report


def _ticked_streams(sched, prompts, first_tokens, rest_tokens):
    """``_staggered_streams`` on one schedule, whatever the timing: the
    scheduler driven by hand (``_tick``) with every result landing at the
    backpressure point (``HostCopy.done`` False): the first prompt alone,
    the rest submitted once its first decode dispatch ran."""
    from generativeaiexamples_tpu_torch.engine import engine as eng
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    done, eng.HostCopy.done = eng.HostCopy.done, lambda self: False
    try:
        reqs = [sched.submit(Request(prompt_ids=prompts[0],
                                     max_tokens=first_tokens,
                                     temperature=0.0))]
        while sched.stats["decode_dispatches"] < 1:
            if not sched._tick():
                raise AssertionError("the first request never decoded")
        reqs += [sched.submit(Request(prompt_ids=p, max_tokens=rest_tokens,
                                      temperature=0.0))
                 for p in prompts[1:]]
        for _ in range(10_000):
            if not sched._tick():
                break
    finally:
        eng.HostCopy.done = done
    if any(r.error or not r.finished_at for r in reqs):
        raise AssertionError(f"a request failed: {[r.error for r in reqs]}")
    return [r.output_ids for r in reqs]


def _moe_card_vs_cpu(dev, cfg, layer, seed=21):
    """``ops.moe`` on the card against the CPU on the same inputs, per
    ``MOE_CASES`` at ``cfg``'s widths with ``layer``'s router and experts:
    the routing (each token's choices, slots and keeps) equal, the outputs
    within ``MOE_TOL`` x max(1, the largest CPU output), every output
    finite, and the forced-drop case dropping. Returns each case's
    readings and the smallest router margin seen (the k-th minus the
    (k+1)-th probability of a token)."""
    import torch
    from generativeaiexamples_tpu_torch.ops import moe
    k, E = cfg.n_experts_per_tok, cfg.n_experts
    host = {key: layer[key].cpu() for key in ("w_router", "w_gate", "w_up",
                                             "w_down")}
    g = torch.Generator(device=dev).manual_seed(seed)
    out, margin = {}, float("inf")
    for name, N, cf in MOE_CASES:
        cf = cf or cfg.capacity_factor
        C = moe.capacity(N, E, k, cf)
        x = torch.randn((N, cfg.dim), generator=g, device=dev)
        with torch.no_grad():
            r_dev = moe.route(x, layer["w_router"], k, C)
            r_cpu = moe.route(x.cpu(), host["w_router"], k, C)
            got, _ = moe.moe_mlp(layer, x, k, cf, cfg.hidden_act)
            want, _ = moe.moe_mlp(host, x.cpu(), k, cf, cfg.hidden_act)
        unequal = [f for f in ("expert_ix", "slot", "keep")
                   if not torch.equal(getattr(r_dev, f).cpu(),
                                      getattr(r_cpu, f))]
        top = r_cpu.probs.sort(-1, descending=True).values
        case_margin = (top[:, k - 1] - top[:, k]).min().item()
        margin = min(margin, case_margin)
        err = (got.cpu() - want).abs().max().item()
        limit = MOE_TOL * max(1.0, want.abs().max().item())
        drops = int((~r_cpu.keep).sum())
        out[name] = dict(tokens=N, capacity_factor=cf, capacity=C,
                         dropped_choices=drops, routing_unequal=unequal,
                         max_abs_err=err, limit=limit,
                         router_margin=case_margin)
        if (unequal or not err <= limit or not bool(torch.isfinite(got).all())
                or (cf < cfg.capacity_factor and drops == 0)):
            raise AssertionError(f"parity_moe: moe_mlp on the card against "
                                 f"the CPU, {name}: {out[name]}")
    return out, margin


def _moe_model(dev, n_layers, dtype, seed):
    """mixtral-8x7b's widths at ``n_layers`` in ``dtype``, random weights
    from ``seed`` on the card, and the seconds the draw took."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.models import llama, model_config
    cfg = dataclasses.replace(model_config("mixtral-8x7b"),
                              n_layers=n_layers, dtype=dtype)
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def phase_parity_moe(dev):
    """mixtral-8x7b's widths (dim 4,096, 32 heads on 8 KV heads of 128, 8
    experts of hidden 14,336, top-2, capacity factor 1.25, V = 32,000), 2
    layers, f32, random weights from seed 3, the kernel path against the
    plain path: the dense API's prefill logits of a two-chunk prompt,
    kernel attention (``flash_prefill``) against plain, within
    ``PARITY_GAP_TOL``, and one dense ``decode_step`` each way
    (``ragged_decode``); greedy streams through the engine over an f32
    pool and an int8 pool with speculation and the mixed dispatch on, token
    for token (``_parity_report``); ``moe_mlp`` on the card against the
    CPU (``_moe_card_vs_cpu``, a forced-drop case included), with the
    smallest router margin seen; and int8 weights: the router and the
    expert stacks stay f32, the four attention projections and the head
    launch ``w8a16_gemm`` (4 a layer a forward pass, one an unembedding).
    Returns the kernel-path runs' launches, summed."""
    import dataclasses
    from collections import Counter
    import torch
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    cfg, params, draw_s = _moe_model(dev, 2, "float32", 3)
    moe_cases, margin = _moe_card_vs_cpu(dev, cfg, params["layers"][0])
    tok = ByteTokenizer()
    prompts = [tok.encode(PROMPT_TEXT * 2, add_bos=True),
               tok.encode(PROMPT_TEXT * 5, add_bos=True)]   # two chunks
    total = Counter()
    ids = torch.tensor([prompts[1]], device=dev)
    seq = torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev)
    logits, steps = {}, {}
    with torch.no_grad():
        for attn in ("kernel", "plain"):
            k.reset_launch_counts()
            acfg = dataclasses.replace(cfg, attn_impl=attn)
            cache = llama.KVCache.create(acfg, 1, 1024, device=dev)
            logits[attn], cache = llama.prefill(
                params, acfg, ids, cache, torch.zeros_like(seq), seq)
            steps[attn], _ = llama.decode_step(
                params, acfg, logits[attn][:, -1].argmax(-1), cache)
            launches = k.launch_counts()
            if (attn == "kernel") != (
                    launches["flash_prefill"] == cfg.n_layers
                    and launches["ragged_decode"] == cfg.n_layers):
                raise AssertionError(f"parity_moe: the {attn} dense API "
                                     f"launched {launches}")
            if attn == "kernel":
                total.update(launches)
    dense = {}
    for what, got, want in (("prefill", logits["kernel"], logits["plain"]),
                            ("decode_step", steps["kernel"],
                             steps["plain"])):
        dense[what] = (got - want).abs().max().item()
        if not (dense[what] <= PARITY_GAP_TOL
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"parity_moe: dense {what} logits, kernel "
                                 f"against plain: {dense[what]} > "
                                 f"{PARITY_GAP_TOL}")
    del logits, steps, cache
    streams, reports, dispatches = {}, {}, {}
    for kv_quant in ("none", "int8"):
        key = ("ragged_paged_attention_int8" if kv_quant == "int8"
               else "ragged_paged_attention")
        logs = []
        for attn in ("kernel", "plain"):
            ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048,
                                page_size=128, prefill_chunk=512,
                                dtype="float32", attention=attn,
                                kv_quant=kv_quant, prefill_hold_chunks=0)
            sched = Scheduler(EngineCore(cfg, ecfg, params, tok.eos_id,
                                         device=dev), tok)
            k.reset_launch_counts()
            with _RoutingLog() as log:
                streams[attn] = _ticked_streams(sched, prompts, 48, 16)
            logs.append(log.calls)
            launches = k.launch_counts()
            if attn == "kernel":
                total.update(launches)
                if not (launches["flash_prefill"] and launches[key]
                        and launches["sample_slots"]):
                    raise AssertionError(f"parity_moe ({kv_quant}) did not "
                                         f"launch the kernels: {launches}")
            if not (sched.stats["mixed_dispatches"]
                    and sched.stats["spec_steps"]):
                raise AssertionError(f"parity_moe ({kv_quant}, {attn}) ran "
                                     f"no mixed or widened step: "
                                     f"{sched.stats}")
            dispatches[f"{kv_quant}, {attn}"] = dict(
                mixed=sched.stats["mixed_dispatches"],
                spec_steps=sched.stats["spec_steps"], launches=launches)
        label = f"mixtral-8x7b width, kv_quant={kv_quant}, kernel vs plain"
        reports[label] = _moe_parity_report(params, cfg, prompts,
                                            streams["kernel"],
                                            streams["plain"], logs, dev,
                                            label)
        margin = min([margin] + [
            (m if v is None else m[v.reshape(-1)]).min().item()
            for _, v, m in logs[1] if v is None or v.any()])
        del logs
    # int8 weights: a copy of the dict, so the f32 set stays as drawn
    qparams = dict(params, layers=[dict(l) for l in params["layers"]])
    ecfg = EngineConfig(max_batch_size=8, max_seq_len=2048, page_size=128,
                        prefill_chunk=512, dtype="float32", quant="int8",
                        prefill_hold_chunks=0)
    core = EngineCore(cfg, ecfg, qparams, tok.eos_id, device=dev)
    layer = core.params["layers"][0]
    kinds = {key: type(layer[key]).__name__ for key in (
        "wq", "wk", "wv", "wo", "w_router", "w_gate", "w_up", "w_down")}
    if not (all(isinstance(layer[key], quant.QTensor)
                for key in ("wq", "wk", "wv", "wo"))
            and all(isinstance(layer[key], torch.Tensor)
                    and layer[key].dtype == torch.float32
                    for key in ("w_router", "w_gate", "w_up", "w_down"))):
        raise AssertionError(f"parity_moe: int8 weights quantized {kinds}")
    sched = Scheduler(core, tok)
    with _ForwardCount() as fwd:
        k.reset_launch_counts()
        sched.start()
        try:
            w8_streams = _staggered_streams(sched, prompts, 16, 8)
        finally:
            sched.stop()
        launches = k.launch_counts()
    need = 4 * cfg.n_layers * fwd.blocks + fwd.unembeds
    if launches["w8a16_gemm"] != need or need == 0:
        raise AssertionError(f"parity_moe: {launches['w8a16_gemm']} "
                             f"w8a16_gemm launches for {fwd.blocks} forward "
                             f"passes and {fwd.unembeds} unembeddings (want "
                             f"{need})")
    total.update(launches)
    emit("parity_moe", ok=True, n_layers=cfg.n_layers, dtype=cfg.dtype,
         draw_s=draw_s, widths=dict(dim=cfg.dim, heads=cfg.n_heads,
                                    kv_heads=cfg.n_kv_heads,
                                    experts=cfg.n_experts,
                                    top_k=cfg.n_experts_per_tok,
                                    hidden=cfg.hidden_dim,
                                    capacity_factor=cfg.capacity_factor,
                                    vocab=cfg.vocab_size),
         prompt_tokens=[len(p) for p in prompts],
         dense_logits_max_abs_err=dense,
         logits_tolerance=f"{PARITY_GAP_TOL} absolute",
         tolerance_top2_gap=PARITY_GAP_TOL, streams=reports,
         dispatches=dispatches, moe_card_vs_cpu=moe_cases,
         moe_tolerance=f"{MOE_TOL} x max(1, the largest CPU output); "
                       f"routing equal",
         min_router_margin=margin, int8_weights=dict(
             leaves=kinds, w8a16_gemm=launches["w8a16_gemm"],
             forward_passes=fwd.blocks, unembeddings=fwd.unembeds,
             tokens=[len(s) for s in w8_streams],
             param_bytes=core.param_bytes),
         launches=dict(total))
    del params, qparams, core, sched
    gc.collect()
    torch.cuda.empty_cache()
    return dict(total)


def phase_parity_block(dev):
    """starcoder2-3b's widths (dim 3,072, 24 heads on 2 KV heads of 128,
    LayerNorm, biases, the plain gelu_tanh MLP of hidden 12,288, V =
    49,152, tied embeddings), 2 layers, f32: random weights from seed 7
    with every bias and norm bias drawn non-zero and every norm weight
    drawn off one. The dense ``forward`` of ``PROMPT_TEXT * 5`` on the
    card against the CPU on the same weights, within 1e-4 x max(1, the
    largest CPU logit). Then the windowed config's refusal on the card: the
    engine at kernel attention and the dense API's ``prefill`` raise
    NotImplementedError naming A.12."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama, model_config
    cfg = dataclasses.replace(model_config("starcoder2-3b"), n_layers=2,
                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(7)
    params = llama.init_params(g, cfg, device=dev)
    drawn = 0
    for tree in [params] + params["layers"]:
        for key, w in tree.items():
            if key.endswith("_b"):
                w.copy_(0.1 * torch.randn(w.shape, generator=g, device=dev))
            elif key.endswith("norm"):
                w.add_(0.2 * torch.randn(w.shape, generator=g, device=dev))
            else:
                continue
            drawn += 1
    tok = ByteTokenizer()
    ids = torch.tensor([tok.encode(PROMPT_TEXT * 5, add_bos=True)],
                       device=dev)
    host = {key: (w.cpu() if key != "layers" else
                  [{n: t.cpu() for n, t in l.items()} for l in w])
            for key, w in params.items()}
    with torch.no_grad():
        t0 = time.perf_counter()
        got = llama.forward(params, cfg, ids)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = llama.forward(host, cfg, ids.cpu())
        cpu_s = time.perf_counter() - t0
    err = (got.cpu() - want).abs().max().item()
    limit = 1e-4 * max(1.0, want.abs().max().item())
    if not (err <= limit and bool(torch.isfinite(got).all())):
        raise AssertionError(f"parity_block: the card's forward against the "
                             f"CPU's: {err} > {limit}")
    refusals = {}
    try:
        EngineCore(cfg, EngineConfig(max_batch_size=8, max_seq_len=2048,
                                     page_size=128, prefill_chunk=512,
                                     dtype="float32"),
                   params, tok.eos_id, device=dev)
    except NotImplementedError as exc:
        refusals["engine"] = str(exc)[:120]
    seq = torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev)
    try:
        llama.prefill(params, cfg, ids, llama.KVCache.create(
            cfg, 1, 1024, device=dev), torch.zeros_like(seq), seq)
    except NotImplementedError as exc:
        refusals["dense_prefill"] = str(exc)[:120]
    if len(refusals) != 2 or not all("A.12" in v for v in refusals.values()):
        raise AssertionError(f"parity_block: the windowed config was not "
                             f"refused on the card: {refusals}")
    emit("parity_block", ok=True, n_layers=cfg.n_layers, dtype=cfg.dtype,
         prompt_tokens=ids.shape[1], drawn_non_zero_leaves=drawn,
         logits_max_abs_err=err, limit=limit,
         tolerance="1e-4 x max(1, the largest CPU logit)",
         largest_logit=want.abs().max().item(), card_forward_s=card_s,
         cpu_forward_s=cpu_s, refusals=refusals,
         widths=dict(dim=cfg.dim, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                     hidden=cfg.hidden_dim, vocab=cfg.vocab_size,
                     norm=cfg.norm, mlp=cfg.mlp, use_bias=cfg.use_bias,
                     window=cfg.sliding_window))
    del params, host, got
    torch.cuda.empty_cache()


# multi-step decode: parity_multi's M ceiling (K 8: blocks of 16 and 32
# steps), and serve_multi's K and M. serve_multi runs the reference
# test's K of 2, so a top block of 16 steps spans 8 per-step dispatches:
# at K 8 a block of 64 steps outgrows the 32-token late prompts and the
# budgets' tails, which then run shallow rungs or per-step dispatches
MULTI_M = 4
MULTI_SERVE_K = 2
MULTI_SERVE_M = 8


def _record_multi(core):
    """Wrap ``core.decode_multi`` to keep, for each multi-step dispatch,
    its stop flags, its suspect table, its out block (fresh tensors no
    later launch writes) and the kernel launches it made
    (``_pause_check`` reads the first three). Returns the list."""
    import numpy as np
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    blocks = []
    multi = core.decode_multi

    def recording(state, table, steps=None, m=None, **kw):
        before = k.launch_counts()
        state, out = multi(state, table, steps, m, **kw)
        after = k.launch_counts()
        blocks.append((np.asarray(kw.get("has_stop")),
                       core._stop_suspect(tuple(kw.get("stops", ()))), out,
                       {n: after[n] - before[n] for n in after}))
        return state, out

    core.decode_multi = recording
    return blocks


def _pause_check(name, blocks):
    """The on-device stop pause of every recorded multi-step block: a slot
    that carries a stop string emits nothing after its first suspect
    token. Returns (suspect tokens seen in stop-bearing slots, those
    before a block's last row: pauses); a slot that ran on past one raises
    KernelMismatch (the planted fault ``multi_running_dropped``)."""
    import numpy as np
    seen = pauses = 0
    for has_stop, table, out, _ in blocks:
        em = out["emitted"].bool()
        sus = (table[out["sampled"].long()] & em).cpu().numpy()
        em = em.cpu().numpy()
        rows = em.shape[0]
        for s in np.flatnonzero(has_stop):
            hits = np.flatnonzero(sus[:, s])
            if not len(hits):
                continue
            seen += 1
            first = int(hits[0])
            after = int(em[first + 1:, s].sum())
            if after:
                raise KernelMismatch(name, {
                    "slot": int(s), "suspect_row": first, "rows": rows,
                    "rows_emitted_after_it": after})
            pauses += first + 1 < rows
    return seen, pauses


def _pick_stop(tok, ids, pauses, length=3):
    """A stop string from the text of ``ids``: ``length`` characters whose
    first occurrence is where they stand, past the first character, with
    no U+FFFD and not all blank; one from a quarter of the way in if there
    is one (a greedy stream of random weights may repeat from its start).
    Of those, the one the most tokens before it share a byte with
    (``pauses``: each such token pauses a multi-step block) or the fewest
    (so the request keeps its depth); None when there is none."""
    text = tok.decode(ids)
    ends = [len(tok.decode(ids[:i + 1])) for i in range(len(ids))]
    pieces = [set(tok.decode([t]).encode()) for t in ids]
    best = None
    for at in range(1, len(text) - length + 1):
        stop = text[at:at + length]
        if "\ufffd" in stop or not stop.strip() or text.find(stop) != at:
            continue
        need = set(stop.encode())
        score = sum(1 for end, piece in zip(ends, pieces)
                    if end <= at and piece & need)
        key = (at >= len(text) // 4, score if pauses else -score, -at)
        if best is None or key > best[0]:
            best = (key, stop)
    return None if best is None else best[1]


def _frequent_stop(tok, ids):
    """A stop string that never matches ``ids``' text but starts with its
    most frequent character: every token holding that character is
    suspect, so a multi-step block holding one pauses the slot."""
    text = tok.decode(ids).replace("\ufffd", "")
    if not text:
        return None
    c = max(set(text), key=text.count)
    return c + "\x00\x01"


def _drive(sched, reqs, timeout=600):
    """Submit ``reqs`` and tick ``sched`` by hand until all finish."""
    for r in reqs:
        sched.submit(r)
    t0 = time.perf_counter()
    while not all(r.finished_at for r in reqs):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"requests unfinished after {timeout} s")
        sched._tick()
    if any(r.error for r in reqs):
        raise AssertionError(f"a request failed: {[r.error for r in reqs]}")
    return reqs


def phase_parity_multi(dev):
    """llama3-8b width, 2 layers, f32, greedy, over a model-dtype pool and
    an int8 pool, with ``decode_multistep=4`` (K 8: blocks of 16 and 32
    steps): three requests through the Scheduler, one of them carrying
    two stop strings, one cut from its own per-step stream (the smoke's
    BPE tokenizer, so the ids decode to text) and one that never matches
    but starts with the stream's most frequent character (so blocks
    pause). The kernel path's multi-step
    streams equal its per-step streams (both at the full batch width, the
    ladder off) with the same finish reasons and texts, and the plain
    path's multi-step streams up to a near-tie (``_parity_report``); in
    every multi-step block a stop-bearing slot emits nothing after its
    first suspect token (``_pause_check``), at least one pause happens,
    and the attention kernel and ``sample_slots`` launch inside the
    multi-step dispatches."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.engine.scheduler import (Request,
                                                                 Scheduler)
    from generativeaiexamples_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype="float32")
    params = llama.init_params(torch.Generator(device=dev).manual_seed(3),
                               cfg, device=dev)
    tok = smoke_tokenizer()["tok"]
    prompts = [tok.encode(PROMPT_TEXT * 2, add_bos=True),
               tok.encode(PROMPT_TEXT * 5, add_bos=True),
               tok.encode("A stop string ends this one. " + PROMPT_TEXT,
                          add_bos=True)]
    budgets = (64, 40, 64)

    def run(kv_quant, attn, multistep, stop):
        ecfg = EngineConfig(
            max_batch_size=8, max_seq_len=2048, page_size=128,
            prefill_chunk=512, dtype="float32", attention=attn,
            kv_quant=kv_quant, spec_decode="off", mixed_phase_dispatch="off",
            decode_width_ladder="off", decode_multistep=multistep)
        core = EngineCore(cfg, ecfg, params, tok.eos_id, device=dev)
        blocks = _record_multi(core) if multistep else []
        sched = Scheduler(core, tok)
        reqs = _drive(sched, [
            Request(prompt_ids=p, max_tokens=n, temperature=0.0,
                    stop=stop if stop and i == 2 else [])
            for i, (p, n) in enumerate(zip(prompts, budgets))])
        return reqs, dict(sched.stats), blocks

    reports, readings = {}, {}
    for kv_quant in ("none", "int8"):
        probe, _, _ = run(kv_quant, "kernel", 0, None)
        stop = [_pick_stop(tok, probe[2].output_ids, pauses=True),
                _frequent_stop(tok, probe[2].output_ids)]
        if None in stop:
            raise AssertionError(f"parity_multi ({kv_quant}): no stop string "
                                 f"in the probe's text")
        step, _, _ = run(kv_quant, "kernel", 0, stop)
        fast, stats, blocks = run(kv_quant, "kernel", MULTI_M, stop)
        plain, pstats, pblocks = run(kv_quant, "plain", MULTI_M, stop)
        label = f"kv_quant={kv_quant}"
        got = [(r.output_ids, r.finish_reason) for r in fast]
        want = [(r.output_ids, r.finish_reason) for r in step]
        if got != want:
            raise KernelMismatch("parity_multi", {
                "path": f"{label}, multi-step vs per-step, kernel",
                "finish": [[a[1], b[1]] for a, b in zip(got, want)],
                "equal": [a == b for a, b in zip(got, want)]})
        reports[f"{label}, kernel vs plain, multi-step"] = _parity_report(
            params, cfg, prompts, [r.output_ids for r in fast],
            [r.output_ids for r in plain], dev,
            f"parity_multi {label}, kernel vs plain")
        seen, pauses = _pause_check("parity_multi", blocks)
        pseen, ppauses = _pause_check("parity_multi", pblocks)
        decode_key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                      else "ragged_paged_attention")
        inside = {n: sum(b[3][n] for b in blocks)
                  for n in (decode_key, "sample_slots")}
        if not stats["multi_dispatches"] or min(inside.values()) < 1:
            raise AssertionError(f"parity_multi ({label}): no multi-step "
                                 f"dispatch through the kernels: {stats}, "
                                 f"{inside}")
        if pauses < 1:
            raise AssertionError(f"parity_multi ({label}): no stop-bearing "
                                 f"slot paused in a block ({seen} suspect "
                                 f"tokens)")
        readings[label] = dict(
            stop=stop, finish_reasons=[r.finish_reason for r in fast],
            tokens=[len(r.output_ids) for r in fast],
            multi_dispatches=stats["multi_dispatches"],
            multi_by_m={m: stats[f"multi_m_{m}"] for m in (2, 4)},
            decode_dispatches=stats["decode_dispatches"],
            per_step_dispatches=stats["decode_dispatches"]
            - stats["multi_dispatches"],
            host_fetches=stats["host_fetches"],
            suspect_tokens=seen, pauses=pauses,
            plain_suspect_tokens=pseen, plain_pauses=ppauses,
            launches_inside_multi=inside,
            plain_multi_dispatches=pstats["multi_dispatches"])
    emit("parity_multi", ok=True, tolerance_top2_gap=PARITY_GAP_TOL,
         streams=reports, runs=readings)
    del params


def parity_multi_cases(dev):
    """``phase_parity_multi`` as one check-only case (the planted faults
    read it): a failed check of any kind is its reading."""
    def case():
        try:
            phase_parity_multi(dev)
        except KernelMismatch:
            raise
        except AssertionError as exc:
            raise KernelMismatch("parity_multi", {"error": str(exc)[:400]})
        return {"passed": True}
    return {"streams_and_pauses": case}


def phase_serve_gemma(dev):
    """gemma-7b at full width and depth (28 layers, dim 3,072, 16 heads and
    16 KV heads of 256, GeGLU hidden 24,576, V = 256,000, tied embeddings,
    8.5 B parameters) on one card: bf16 weights drawn from seed 0, a bf16
    KV pool of 8 slots of 2,048 tokens, the engine's defaults, behind the
    HTTP server: ``serve``'s staggered traffic, then one
    ``response_format: json_object`` request (``phase_serve`` with
    ``json_request``), every request 200, the JSON reply parsing, the
    attention kernels at head_dim 256 and the sampler at V = 256,000
    launched. Returns the launches."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama, model_config
    cfg = model_config("gemma-7b")
    # the parity phases' engine cores live on in reference cycles until
    # the collector runs: collect first, so the reading is the weights'
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    torch.cuda.synchronize()
    emit("weights_gemma", model="gemma-7b", dtype=cfg.dtype,
         init_weights_s=time.perf_counter() - t0,
         allocated_gb=torch.cuda.memory_allocated() / 1e9,
         peak_during_init_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches, core = phase_serve(dev, cfg, params, model="gemma-7b",
                                 name="serve_gemma", json_request=True)
    del core, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches



def phase_serve_moe(dev):
    """mixtral-8x7b at full width and ``SERVE_MOE_LAYERS`` layers (its 32
    take 93.4 GB in bf16, past one card): bf16 weights from seed 0, a bf16
    pool of 8 slots of 2,048 tokens, the engine's defaults, behind the
    HTTP server: ``serve``'s staggered traffic, 256 tokens a decoder
    (``phase_serve``: every request 200,
    ``flash_prefill``, ``ragged_paged_attention`` and ``sample_slots``
    launched), then one profiled decode step (``profile_moe``). Returns
    the launches."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, draw_s = _moe_model(dev, SERVE_MOE_LAYERS, "bfloat16", 0)
    emit("weights_moe", model="mixtral-8x7b", n_layers=cfg.n_layers,
         dtype=cfg.dtype, init_weights_s=draw_s,
         allocated_gb=torch.cuda.memory_allocated() / 1e9,
         peak_during_init_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches, core = phase_serve(dev, cfg, params, model="mixtral-8x7b",
                                 name="serve_moe")
    emit("profile_moe", **timed("profile_moe", profile_moe, core))
    del core, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_moe(core):
    """One full-batch decode step of an MoE model under ``torch.profiler``
    (``profile_decode``, 8 slots at 1,000 tokens), with the device time of
    each MoE stage (``ops.moe``: route, dispatch, experts, combine) under
    a ``record_function`` range of its own, against the MoE's bound: the
    capacity formulation runs every expert (C >= 8 slots each), so a step
    reads every expert's weights once, over 3.35 TB/s."""
    import torch
    from generativeaiexamples_tpu_torch.ops import moe
    saved = {name: getattr(moe, name) for name in MOE_STAGES}

    def ranged(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function("moe_" + name):
                return fn(*args, **kw)
        return run

    for name, fn in saved.items():
        setattr(moe, name, ranged(name, fn))
    try:
        prof = profile_decode(core, steps=1, ranges=tuple(
            "moe_" + name for name in MOE_STAGES))
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)
    by = prof["device_ms_per_step_by_class"]
    moe_ms = sum(by["moe_" + name] for name in MOE_STAGES)
    expert_bytes = sum(layer[key].numel() * layer[key].element_size()
                       for layer in core.params["layers"]
                       for key in ("w_router", "w_gate", "w_up", "w_down"))
    bound = expert_bytes / PEAK_BYTES * 1e3
    if moe_ms <= 0:
        raise AssertionError(f"profile_moe: no device time under the MoE "
                             f"ranges: {by}")
    return dict(prof, moe_device_ms_per_step=moe_ms,
                moe_bound_ms=bound, moe_bound_by="bytes",
                moe_expert_bytes=expert_bytes,
                moe_share_of_bound=bound / moe_ms,
                moe_share_of_device=moe_ms / prof["device_ms_per_step"])


# serve_multi's stop-bearing request: 64 greedy tokens, sent after the
# decoders in the first wave
STOP_PROMPT = "A request whose stop string ends it. " + PROMPT_TEXT
STOP_TOKENS = 64


def _serve_multi_run(dev, cfg, params, tok, texts, stop, multistep,
                     steps_max=0, late=True, decoder_tokens=256):
    """One run of ``serve_multi`` behind the HTTP server: ``serve``'s
    traffic in the smoke tokenizer's tokens (``texts``) and the
    stop-bearing request, in a fixed order: the first wave (the decoders,
    then the stop request) is admitted together once all of it arrived,
    the late prompts (``late``) together once the first decode dispatch
    ran. Speculation, the mixed dispatch and the width ladder are off, so
    every decode row runs at the full batch and a request's tokens do not
    depend on when the others run. The launch counts, the stats and the
    engine's sampling calls are set to 0 just before the traffic and read
    just after. Returns (fields, each request's output ids, launches)."""
    import torch
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    core = serving_core(dev, cfg, params, eos_id=tok.eos_id,
                        spec_decode="off", mixed_phase_dispatch="off",
                        decode_width_ladder="off",
                        decode_steps_per_dispatch=MULTI_SERVE_K,
                        decode_multistep=multistep,
                        decode_steps_max=steps_max)
    warmup_s = core.warmup()
    # the byte table before the traffic, as the server's warmup with its
    # tokenizer builds it: else the first multi-step dispatch with a stop
    # string builds it (a host decode an id) on the scheduler's thread
    core.ensure_token_bytes(tok)
    blocks = _record_multi(core) if multistep else []
    sched = Scheduler(core, tok)
    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)

    sched.submit = recording_submit
    gate = _gate_admission(sched)
    # this run's peak: the runs before it left reference cycles behind
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    httpd, thread = serve_in_thread(sched, "llama3-8b-random")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    # (seed, prompt, tokens, chat, sampling): the stop request is a
    # completion, so its prompt is the probe's
    first = [(i, text, decoder_tokens, i % 2 == 0,
              dict(temperature=0.0 if i % 2 else 0.7))
             for i, text in enumerate(texts[0])]
    first.append((len(first), STOP_PROMPT, STOP_TOKENS, False,
                  dict(temperature=0.0, stop=[stop])))
    second = [(len(first) + i, texts[1], 32, i == 0, dict(temperature=0.0))
              for i in range(2 if late else 0)]

    def wave(pool, specs):
        gate.clear()
        futs = []
        for i, text, tokens, chat, kw in specs:
            n = len(submitted)
            futs.append(pool.submit(_request, base, i, text, tokens, chat,
                                    False, **kw))
            _wait_for(lambda: len(submitted) > n, "a request did not arrive")
        gate.set()
        sched._wake.set()
        return futs

    try:
        k.reset_launch_counts()
        for key in sched.stats:
            sched.stats[key] = 0
        core.sample_calls = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = wave(pool, first)
            _wait_for(lambda: sched.stats["decode_dispatches"] >= 1,
                      "no decode dispatch")
            futs += wave(pool, second)
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches = k.launch_counts()
        stats = dict(sched.stats)
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=30)
    bad = [r for r in results if r["status"] != 200 or not r["usage"]]
    if bad or any(r.error for r in submitted):
        raise AssertionError(f"serve_multi: a request failed: {bad}, "
                             f"{[r.error for r in submitted]}")
    gen = sum(r["usage"]["completion_tokens"] for r in results)
    inside = {n: sum(b[3][n] for b in blocks)
              for n in ("ragged_paged_attention", "sample_slots")}
    fields = dict(
        decode_multistep=multistep, decode_steps_max=steps_max,
        completion_tokens=gen, wall_s=wall, gen_tok_s=gen / wall,
        host_fetches=stats["host_fetches"],
        host_fetches_per_token=stats["host_fetches"] / gen,
        multi_dispatches=stats["multi_dispatches"],
        multi_by_m={m: stats[f"multi_m_{m}"] for m in core.multi_ms},
        decode_dispatches=stats["decode_dispatches"],
        decode_steps=stats["decode_steps"],
        dispatches_by_depth={key: n for key, n in stats.items()
                             if key.startswith("decode_depth_")},
        server_ttft_s=sorted(round(r.first_token_at - r.submitted_at, 4)
                             for r in submitted if r.first_token_at),
        finish_reasons=[r.finish_reason for r in submitted],
        stop_request=dict(stop=stop, finish_reason=submitted[len(first) - 1]
                          .finish_reason,
                          tokens=len(submitted[len(first) - 1].output_ids)),
        launches=launches, launches_inside_multi=inside,
        sample_calls=core.sample_calls, warmup_s=warmup_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    streams = [list(r.output_ids) for r in submitted]
    del core, sched, blocks
    gc.collect()
    torch.cuda.empty_cache()
    return fields, streams, launches


def phase_serve_multi(dev, cfg, params):
    """llama3-8b at full width and depth, bf16, seeded, 8 slots of 2,048,
    over the smoke's BPE tokenizer (so the stop string reads text):
    ``serve``'s traffic plus one greedy request with a stop string, at
    ``spec_decode=off`` and K = 2 (``MULTI_SERVE_K``), twice on the loaded
    weights: ``decode_multistep`` 0, then 8. The stop string is cut from
    the stop request's own per-step stream, run alone first, where the
    fewest of its tokens would pause a block. Every request answers 200 and both runs give
    each request the same tokens and finish reason; host fetches per
    generated token drop at least 4x; the multi run's multi-step
    dispatches launch the ragged-paged kernel and ``sample_slots``, and a
    stop-bearing slot never runs past a suspect token (``_pause_check``).
    A third, short run (the decoders at 64 tokens, no late prompts) with
    ``decode_steps_max=32`` and multi-step off must deepen a dispatch past
    the base K (``decode_depth_<k>``). Then ``profile_multi``: a K 2
    core's multi-step dispatch of 4 steps beside a per-step one of 2 (8
    slots at 1,000 tokens), the device operations a step the stop ring
    and the suspect lookup add. Returns the multi run's launches."""
    from generativeaiexamples_tpu_torch.engine.scheduler import (Request,
                                                                 Scheduler)
    tok = smoke_tokenizer()["tok"]
    texts = _traffic_texts(tok)
    seconds = {}
    t0 = time.perf_counter()
    probe_core = serving_core(dev, cfg, params, eos_id=tok.eos_id,
                              spec_decode="off", mixed_phase_dispatch="off",
                              decode_width_ladder="off")
    probe = _drive(Scheduler(probe_core, tok), [Request(
        prompt_ids=tok.encode(STOP_PROMPT, add_bos=True),
        max_tokens=STOP_TOKENS, temperature=0.0)])[0]
    del probe_core
    gc.collect()
    stop = _pick_stop(tok, probe.output_ids, pauses=False)
    if stop is None:
        raise AssertionError("serve_multi: no stop string in the probe")
    seconds["probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    off, off_streams, _ = _serve_multi_run(dev, cfg, params, tok, texts,
                                           stop, 0)
    seconds["per_step_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on, on_streams, launches = _serve_multi_run(dev, cfg, params, tok,
                                                texts, stop, MULTI_SERVE_M)
    seconds["multi_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deep, _, _ = _serve_multi_run(dev, cfg, params, tok, texts, stop, 0,
                                  steps_max=32, late=False,
                                  decoder_tokens=64)
    seconds["depth_run"] = time.perf_counter() - t0
    faults = []
    if on_streams != off_streams or on["finish_reasons"] != off[
            "finish_reasons"]:
        faults.append("the multi-step run's streams differ from the "
                      "per-step run's: " + str([a == b for a, b in zip(
                          on_streams, off_streams)]))
    if on["multi_dispatches"] < 1 or min(
            on["launches_inside_multi"].values()) < 1:
        faults.append("no multi-step dispatch through the kernels")
    if on["host_fetches_per_token"] > off["host_fetches_per_token"] / 4:
        faults.append("host fetches per token dropped less than 4x")
    if not any(n for key, n in deep["dispatches_by_depth"].items()
               if int(key.rsplit("_", 1)[1]) > MULTI_SERVE_K):
        faults.append(f"no dispatch deepened past {MULTI_SERVE_K} steps")
    if faults:
        raise AssertionError(f"serve_multi: {'; '.join(faults)}: "
                             f"{off}, {on}, {deep}")
    t0 = time.perf_counter()
    core = serving_core(dev, cfg, params, spec_decode="off",
                        decode_steps_per_dispatch=2, decode_multistep=2)
    prof = profile_decode(core, steps=2)
    prof_multi = profile_decode(core, steps=2, multi_m=2)
    seconds["profile_multi"] = time.perf_counter() - t0
    del core
    emit("serve_multi", model="llama3-8b", tokenizer=type(tok).__name__,
         probe_tokens=len(probe.output_ids), stop=stop,
         streams_equal=True, per_step=off, multi=on, depth_ladder=deep,
         fetch_drop=off["host_fetches_per_token"]
         / on["host_fetches_per_token"],
         profile_multi=dict(
             per_step={key: prof[key] for key in (
                 "steps", "device_ops_per_step", "decode_ms_per_step",
                 "device_ms_per_step", "device_busy_share")},
             multi={key: prof_multi[key] for key in (
                 "steps", "device_ops_per_step", "decode_ms_per_step",
                 "device_ms_per_step", "device_busy_share")},
             device_ops_added_per_step=prof_multi["device_ops_per_step"]
             - prof["device_ops_per_step"]), seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# KV movement: the prefill/decode handoff, evacuation and spill
# ---------------------------------------------------------------------------

# serve_disagg's traffic: serve's decoders at 96 tokens (wave 1), then
# serve's two late prompts and one json_object chat (wave 2); the spill run
# re-sends wave 1 into a pool of DISAGG_PAGES pages, where decode growth
# preempts
DISAGG_TOKENS = 96
DISAGG_PAGES = 36
DISAGG_SPILL_MB = 4096
EVAC_TEXT = PROMPT_TEXT * 4
EVAC_TOKENS = 96
EVAC_PULL_TOKENS = 16  # the pull comes once this many tokens were made
# the tier case: a returning request decodes this many tokens (its stream
# is held against the first of the unified one's); the oracle's replay of
# the wave only prefills it (its pages then sit in the prefix cache)
TIER_RETURN_TOKENS = 32
TIER_ORACLE_WAVE_TOKENS = 2


def _disagg_traffic(json_request=True):
    """(wave 1, wave 2) of (i, text, tokens, chat, sampling): serve's
    decoders (temperature 0.7 seeded for even i, greedy for odd), then its
    late prompts and, with ``json_request``, one json_object chat."""
    first = [(i, PROMPT_TEXT * n, DISAGG_TOKENS, i % 2 == 0,
              dict(temperature=0.7 if i % 2 == 0 else 0.0))
             for i, n in enumerate(DECODERS)]
    second = [(4 + i, PROMPT_TEXT * LATE_PROMPT, 32, i == 0,
               dict(temperature=0.0)) for i in range(2)]
    if json_request:
        second.append((6, JSON_PROMPT, 48, True, dict(
            temperature=0.0, response_format={"type": "json_object"})))
    return first, second


class _Worker:
    """One scheduler behind the stdlib HTTP server in a thread, its
    admission gated (``_gate_admission``) and every request it is given
    recorded (``submit`` and ``submit_prefilled``). ``watchdog``: an
    engine watchdog (``engine/watchdog.py``, its poll thread started) is
    the server's health arbiter, so ``POST /debug/drain`` drains."""

    def __init__(self, core, tok, watchdog=False):
        from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
        from generativeaiexamples_tpu_torch.engine.server import (
            serve_in_thread)
        from generativeaiexamples_tpu_torch.engine.watchdog import (
            EngineWatchdog)
        self.core = core
        self.sched = sched = Scheduler(core, tok)
        self.submitted = []
        for name in ("submit", "submit_prefilled"):
            fn = getattr(sched, name)

            def recording(req, *args, _fn=fn):
                out = _fn(req, *args)
                self.submitted.append(req)
                return out
            setattr(sched, name, recording)
        self.gate = _gate_admission(sched)
        self.watchdog = EngineWatchdog(sched) if watchdog else None
        if self.watchdog is not None:
            self.watchdog.start()
        self.httpd, self.thread = serve_in_thread(
            sched, "llama3-8b-random", watchdog=self.watchdog)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        if self.watchdog is not None:
            self.watchdog.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.sched.stop()
        self.thread.join(timeout=30)


def _post(url, body, headers, timeout=600):
    """POST ``body`` (bytes); (status, headers, raw reply)."""
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _kv_prefill_post(base, i, text, max_tokens, chat, temperature=0.0,
                     response_format=None):
    """``/v1/kv/prefill`` for the i-th request (seed i) with the frame
    Accept: (status, frame, client seconds)."""
    from generativeaiexamples_tpu_torch.core import kv_wire
    body = {"max_tokens": max_tokens, "temperature": temperature, "seed": i}
    if response_format is not None:
        body["response_format"] = response_format
    if chat:
        body["messages"] = [{"role": "user", "content": text}]
    else:
        body["prompt"] = text
    t0 = time.perf_counter()
    status, headers, frame = _post(
        base + "/v1/kv/prefill", json.dumps(body).encode(),
        {"Content-Type": "application/json",
         "Accept": kv_wire.KV_FRAMES_CONTENT_TYPE})
    if status != 200 or headers.get("Content-Type") != \
            kv_wire.KV_FRAMES_CONTENT_TYPE:
        raise AssertionError(f"/v1/kv/prefill {i}: {status} {frame[:300]}")
    return frame, time.perf_counter() - t0


def _sse_read(resp, on_content=None):
    """The content of an SSE chat stream, its last finish reason and the
    seconds to its first content (``on_content(text so far)`` after each
    content chunk)."""
    t0 = time.perf_counter()
    parts, finish, first = [], None, None
    for line in resp:
        line = line.decode().strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[len("data: "):])
        if chunk.get("error"):
            raise AssertionError(f"stream error: {chunk['error']}")
        choice = chunk["choices"][0]
        content = choice["delta"].get("content")
        if content:
            if first is None:
                first = time.perf_counter() - t0
            parts.append(content)
            if on_content is not None:
                on_content("".join(parts))
        finish = choice.get("finish_reason") or finish
    return "".join(parts), finish, first


def _kv_handoff_post(base, frame, resume_chars=None):
    """POST a frame to ``/v1/kv/handoff``: (text, finish reason, seconds
    to the first content, seconds in all)."""
    from generativeaiexamples_tpu_torch.core import kv_wire
    headers = {"Content-Type": kv_wire.KV_FRAMES_CONTENT_TYPE}
    if resume_chars is not None:
        headers["X-Resume-Chars"] = str(resume_chars)
    req = urllib.request.Request(base + "/v1/kv/handoff", data=frame,
                                 headers=headers)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        text, finish, first = _sse_read(resp)
    return text, finish, first, time.perf_counter() - t0


def _wave(pool, worker, specs, send):
    """Post ``specs`` in their order, each once the one before arrived,
    and admit them together: the same grouped prefill in every run."""
    worker.gate.clear()
    futs = []
    for spec in specs:
        n = len(worker.submitted)
        futs.append(pool.submit(send, spec))
        _wait_for(lambda: len(worker.submitted) > n,
                  "a request did not arrive")
    worker.gate.set()
    worker.sched._wake.set()
    return futs


def _disagg_core(dev, cfg, params, role, kv_quant="none", **knobs):
    """A serve_disagg engine: 8 slots of 2,048 over its own pool, rows
    independent of timing (speculation, the mixed dispatch, the width
    ladder and the prefix cache off), the role given."""
    return serving_core(dev, cfg, params, kv_quant, role=role,
                        spec_decode="off", mixed_phase_dispatch="off",
                        decode_width_ladder="off", prefix_cache="off",
                        **knobs)


def _launch_window(k):
    """Launch counts since the last reset, then reset."""
    got = k.launch_counts()
    k.reset_launch_counts()
    return got


def _add_launches(total, got):
    for key, n in got.items():
        total[key] = total.get(key, 0) + n


def _handoff_case(dev, cfg, params, tok, kv_quant, total):
    """Case 1: the traffic unified on a decode worker, then prefilled on a
    prefill worker (frames) and handed to the decode worker. Returns
    (readings, the unified requests by prompt, the workers)."""
    from generativeaiexamples_tpu_torch.core import kv_wire
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    decode_key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                  else "ragged_paged_attention")
    json_request = kv_quant == "none"
    first, second = _disagg_traffic(json_request)
    pre = _Worker(_disagg_core(dev, cfg, params, "prefill", kv_quant), tok)
    dec = _Worker(_disagg_core(dev, cfg, params, "decode", kv_quant), tok,
                  watchdog=True)
    try:
        def unified(spec):
            i, text, tokens, chat, kw = spec
            return _request(dec.base, i, text, tokens, chat, False, **kw)

        k.reset_launch_counts()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = _wave(pool, dec, first, unified)
            _wait_for(lambda: dec.sched.stats["decode_dispatches"] >= 1,
                      "no decode dispatch")
            futs += _wave(pool, dec, second, unified)
            uni_results = [f.result() for f in futs]
        uni_launches = _launch_window(k)
        _add_launches(total, uni_launches)
        uni_reqs = list(dec.submitted)

        # the prefill worker: the same waves through /v1/kv/prefill
        def prefill(spec):
            i, text, tokens, chat, kw = spec
            return _kv_prefill_post(pre.base, i, text, tokens, chat, **kw)

        # each request's journey, keyed by its length in tokens: frame
        # bytes and host seconds of the codec, device-synchronized seconds
        # of the export and the import
        log = {}
        encode, decode = kv_wire.encode_for_wire, kv_wire.decode_kv_frames
        export, imp = pre.core.export_slot_kv, dec.core.import_slot_kv

        def note(length, **fields):
            log.setdefault(int(length), {}).update(fields)

        def timed_encode(payload, binary):
            t0 = time.perf_counter()
            out = encode(payload, binary)
            note(payload["length"], frame_bytes=len(out[0]),
                 encode_s=time.perf_counter() - t0)
            return out

        def timed_decode(body, *a, **kw):
            t0 = time.perf_counter()
            out = decode(body, *a, **kw)
            note(out["length"], decode_s=time.perf_counter() - t0)
            return out

        def synced(fn, key, length):
            def run(*a, **kw):
                import torch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                note(length(a, out), **{key: time.perf_counter() - t0})
                return out
            return run

        kv_wire.encode_for_wire = timed_encode
        kv_wire.decode_kv_frames = timed_decode
        pre.core.export_slot_kv = synced(export, "export_s",
                                         lambda a, out: out["length"])
        dec.core.import_slot_kv = synced(imp, "import_s",
                                         lambda a, out: a[3]["length"])
        try:
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                futs = _wave(pool, pre, first, prefill)
                frames = [f.result() for f in futs]
                futs = _wave(pool, pre, second, prefill)
                frames += [f.result() for f in futs]
            pre_launches = _launch_window(k)
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                handed = [f.result() for f in [
                    pool.submit(_kv_handoff_post, dec.base, frame)
                    for frame, _ in frames]]
            dec_launches = _launch_window(k)
        finally:
            kv_wire.encode_for_wire, kv_wire.decode_kv_frames = encode, decode
            pre.core.export_slot_kv = export
            dec.core.import_slot_kv = imp
        _add_launches(total, pre_launches)
        _add_launches(total, dec_launches)
        handoff_reqs = dec.submitted[len(uni_reqs):]
        faults = []
        if pre.sched.stats["decode_dispatches"] or pre_launches[decode_key]:
            faults.append(f"the prefill worker decoded: "
                          f"{pre.sched.stats['decode_dispatches']} "
                          f"dispatches, {pre_launches[decode_key]} "
                          f"{decode_key} launches")
        if dec_launches["flash_prefill"]:
            faults.append(f"the decode worker ran flash_prefill "
                          f"{dec_launches['flash_prefill']} times for "
                          f"handed-off requests")
        for name, got in (("prefill worker", pre_launches),
                          ("decode worker", dec_launches)):
            need = ["sample_slots"] + (["grammar_mask"] if json_request
                                       else [])
            need.append("flash_prefill" if name == "prefill worker"
                        else decode_key)
            faults += [f"the {name} never launched {n}" for n in need
                       if got[n] < 1]
        by_prompt = {tuple(r.prompt_ids): r for r in uni_reqs}
        equal = []
        for r in handoff_reqs:
            u = by_prompt.get(tuple(r.prompt_ids))
            equal.append(u is not None and u.output_ids == r.output_ids
                         and u.finish_reason == r.finish_reason)
        if len(handoff_reqs) != len(uni_reqs) or not all(equal):
            faults.append(f"handed-off streams differ from the unified "
                          f"ones: {equal}")
        if any(r.error for r in uni_reqs + handoff_reqs) or any(
                r["status"] != 200 for r in uni_results):
            faults.append("a request failed")
        if json_request:
            attached = [r.grammar_attached for r in handoff_reqs
                        if r.grammar is not None]
            if attached != [True]:
                faults.append(f"the json_object handoff's grammar "
                              f"attached {attached}")
        if faults:
            raise AssertionError(f"serve_disagg handoff ({kv_quant}): "
                                 f"{'; '.join(faults)}")

        per_request = []
        for length, got in sorted(log.items()):
            row = {"tokens": length, "frame_bytes": got["frame_bytes"]}
            for step in ("export", "encode", "decode", "import"):
                sec = got[f"{step}_s"]
                row[f"{step}_ms"] = sec * 1e3
                row[f"{step}_gb_s"] = got["frame_bytes"] / sec / 1e9
            per_request.append(row)
        readings = dict(
            kv_quant=kv_quant, requests=len(handoff_reqs),
            streams_equal=True,
            completion_tokens=[len(r.output_ids) for r in handoff_reqs],
            prefill_client_s=[s for _, s in frames],
            per_request=per_request,
            note=("export and import ms: the engine call between two "
                  "torch.cuda.synchronize (device work and the upload); "
                  "encode and decode ms: the wire codec on the host"),
            launches_unified=uni_launches, launches_prefill=pre_launches,
            launches_handoff=dec_launches,
            prefill_worker=dict(
                decode_dispatches=pre.sched.stats["decode_dispatches"],
                prefill_dispatches=pre.sched.stats["prefill_dispatches"],
                kv_handoff_exports=pre.sched.stats["kv_handoff_exports"]),
            decode_worker=dict(
                kv_handoff_imports=dec.sched.stats["kv_handoff_imports"],
                prefill_dispatches=dec.sched.stats["prefill_dispatches"]))
        return readings, by_prompt, pre, dec
    except BaseException:
        pre.close()
        dec.close()
        raise


def _pull_case(src, peer, oracle, name, total, drain=False):
    """Case 2: stream EVAC_TEXT from ``src``; once the request has
    generated EVAC_PULL_TOKENS tokens, pull it through
    ``/v1/kv/evacuation/<rid>`` (from another thread: random weights
    under the byte tokenizer stream few characters), and resume the frame
    on ``peer`` with ``X-Resume-Chars`` the characters the client got: the
    joined text and the resumed request's ids must equal ``oracle``'s.
    ``drain``: the worker is drained mid-stream instead (``POST
    /debug/drain?evacuate=1``, ``src`` has a watchdog): the drain's
    summary names the request among its snapshots, ``/health`` answers
    503, the parked snapshot is pulled and resumed as above, and
    ``?off=1`` brings ``/health`` back to 200; both workers decode
    (``decode_dispatches`` moves on each)."""
    from generativeaiexamples_tpu_torch.core import kv_wire
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    at_evac = []
    evacuate = src.sched._do_evacuate

    def recording(rids, reason):
        at_evac.append([d.positions for d in src.sched._inflight])
        return evacuate(rids, reason)

    src.sched._do_evacuate = recording
    body = {"messages": [{"role": "user", "content": EVAC_TEXT}],
            "max_tokens": EVAC_TOKENS, "temperature": 0.7, "seed": 7,
            "stream": True}
    pulled = {}
    n0 = len(src.submitted)

    def pull():
        _wait_for(lambda: len(src.submitted) > n0, "the request to arrive")
        req = src.submitted[n0]
        _wait_for(lambda: req.completion_tokens >= EVAC_PULL_TOKENS
                  or req.finished_at is not None, "tokens to pull at")
        at = req.completion_tokens
        t0 = time.perf_counter()
        if drain:
            d_status, _, d_raw = _post(src.base + "/debug/drain?evacuate=1",
                                       b"", {})
            summary = json.loads(d_raw)
            h_status, _, h_raw = _get(src.base + "/health", {})
            pulled.update(drain_status=d_status, drain=summary,
                          health_draining=h_status,
                          health_body=json.loads(h_raw),
                          drain_s=time.perf_counter() - t0)
        status, _, frame = _get(
            src.base + f"/v1/kv/evacuation/{req.request_id}",
            {"Accept": kv_wire.KV_FRAMES_CONTENT_TYPE})
        pulled.update(frame=frame, status=status, rid=req.request_id,
                      pull_s=time.perf_counter() - t0, at_tokens=at)

    k.reset_launch_counts()
    dispatches0 = (src.sched.stats["decode_dispatches"],
                   peer.sched.stats["decode_dispatches"])
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            puller = pool.submit(pull)
            req = urllib.request.Request(
                src.base + "/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                pre, finish, _ = _sse_read(resp)
            puller.result()
    finally:
        src.sched._do_evacuate = evacuate
    rid = pulled["rid"]
    again, _, _ = _get(src.base + f"/v1/kv/evacuation/{rid}", {})
    faults = []
    if pulled.get("status") != 200:
        faults.append(f"the pull answered {pulled.get('status')}")
    if finish != "evacuated":
        faults.append(f"the pulled stream ended {finish!r}")
    if again != 404:
        faults.append(f"a second pull answered {again}")
    drained = {}
    if drain:
        off_status, _, _ = _post(src.base + "/debug/drain?off=1", b"", {})
        after, _, _ = _get(src.base + "/health", {})
        drained = dict(drain_status=pulled["drain_status"],
                       health_while_draining=pulled["health_draining"],
                       health_after_off=after, off_status=off_status,
                       drain_s=pulled["drain_s"],
                       evacuation=pulled["drain"].get("evacuation"),
                       watchdog=pulled["health_body"].get("watchdog"))
        if (pulled["drain_status"] != 200 or pulled["health_draining"] != 503
                or off_status != 200 or after != 200
                or rid not in (pulled["drain"].get("evacuation") or {})
                .get("snapshot", [])):
            faults.append(f"the drain surface: {drained}")
    if faults:
        raise AssertionError(f"{name}: {'; '.join(faults)}")
    n_peer = len(peer.submitted)
    rest, rfinish, _, resume_s = _kv_handoff_post(peer.base, pulled["frame"],
                                                  resume_chars=len(pre))
    launches = _launch_window(k)
    _add_launches(total, launches)
    resumed = peer.submitted[n_peer]
    decoded = (src.sched.stats["decode_dispatches"] - dispatches0[0],
               peer.sched.stats["decode_dispatches"] - dispatches0[1])
    if drain and (min(decoded) < 1
                  or launches.get("ragged_paged_attention", 0) < 1
                  or launches.get("sample_slots", 0) < 1):
        raise AssertionError(f"{name}: a worker made no decode dispatch "
                             f"or the kernels did not launch: dispatches "
                             f"{decoded}, launches {launches}")
    joined_equal = pre + rest == oracle["text"]
    ids_equal = resumed.output_ids == oracle["ids"]
    if not (joined_equal and ids_equal) or resumed.snapshot_resumes != 1:
        raise AssertionError(
            f"{name}: the resumed stream differs from the unevacuated one "
            f"(text equal {joined_equal}, ids equal {ids_equal}, "
            f"{len(pre)} + {len(rest)} chars for {len(oracle['text'])}, "
            f"snapshot_resumes {resumed.snapshot_resumes})")
    return dict(pulled_at_tokens=pulled["at_tokens"], pull_s=pulled["pull_s"],
                client_chars_before=len(pre),
                frame_bytes=len(pulled["frame"]), resume_s=resume_s,
                inflight_positions_at_evacuation=at_evac,
                generated_before=len(resumed.output_ids)
                - resumed.completion_tokens,
                finish_reason=rfinish, launches=launches,
                decode_dispatches=decoded, **drained)


def _get(url, headers):
    """GET ``url``: (status, headers, raw reply)."""
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _evacuation_case(dev, cfg, params, tok, dec, total):
    """Case 2: the unevacuated stream of EVAC_TEXT on a peer, then the same
    request pulled from ``dec`` (per-step) and from a decode worker with
    ``decode_multistep=8`` at K 2 (blocks of 16 steps in flight), each
    resumed on the peer."""
    peer = _Worker(_disagg_core(dev, cfg, params, "decode"), tok)
    multi = _Worker(_disagg_core(dev, cfg, params, "decode",
                                 decode_steps_per_dispatch=MULTI_SERVE_K,
                                 decode_multistep=MULTI_SERVE_M), tok)
    try:
        from generativeaiexamples_tpu_torch.ops.cuda import attention as k
        k.reset_launch_counts()
        n = len(peer.submitted)
        got = _request(peer.base, 7, EVAC_TEXT, EVAC_TOKENS, True, False,
                       temperature=0.7)
        _add_launches(total, _launch_window(k))
        oracle = {"text": got["text"], "ids": list(peer.submitted[n]
                                                    .output_ids)}
        if got["status"] != 200 or len(oracle["ids"]) < EVAC_TOKENS // 2:
            raise AssertionError(f"serve_disagg evacuation: the oracle "
                                 f"stopped at {len(oracle['ids'])} tokens")
        per_step = _pull_case(dec, peer, oracle, "evacuation per-step",
                              total)
        blocks = _pull_case(multi, peer, oracle, "evacuation multi-step",
                            total)
        drained = _pull_case(dec, peer, oracle, "evacuation drain", total,
                             drain=True)
        if not any(p > MULTI_SERVE_K for p in sum(
                blocks["inflight_positions_at_evacuation"], [])):
            raise AssertionError(
                f"serve_disagg evacuation: no multi-step block in flight "
                f"when the pull evacuated: "
                f"{blocks['inflight_positions_at_evacuation']}")
        return dict(oracle_tokens=len(oracle["ids"]), per_step=per_step,
                    drain=drained,
                    multi_step=dict(blocks, multi_dispatches=multi.sched
                                    .stats["multi_dispatches"]),
                    streams_equal=True)
    finally:
        peer.close()
        multi.close()


def _spill_case(dev, cfg, params, tok, unified, total):
    """Case 3: wave 1 into a pool of DISAGG_PAGES pages with the spill pool
    armed: decode growth preempts, the victims' pages go to host RAM and
    come back without a prefill (no grouped prefill carries a chunk of a
    promoted job, so no flash_prefill launch is made for one), and the
    streams equal the roomy run's."""
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    first, _ = _disagg_traffic()
    core = _disagg_core(dev, cfg, params, "decode", num_pages=DISAGG_PAGES,
                        kv_spill_mb=DISAGG_SPILL_MB)
    tight = _Worker(core, tok)
    promoted_prefill = {"calls": 0, "flash_prefill": 0}
    prefill_group = core.prefill_group

    def watched(state, items, *a, **kw):
        jobs = {j.slot: j for j in tight.sched._prefilling}
        promoted = any(jobs[it.slot].request.spill_resumes
                       for it in items if it.slot in jobs)
        before = k.launch_counts()["flash_prefill"]
        out = prefill_group(state, items, *a, **kw)
        if promoted:
            promoted_prefill["calls"] += 1
            promoted_prefill["flash_prefill"] += (
                k.launch_counts()["flash_prefill"] - before)
        return out

    core.prefill_group = watched
    try:
        def send(spec):
            i, text, tokens, chat, kw = spec
            return _request(tight.base, i, text, tokens, chat, False, **kw)

        k.reset_launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            results = [f.result() for f in _wave(pool, tight, first, send)]
        wall = time.perf_counter() - t0
        launches = _launch_window(k)
        _add_launches(total, launches)
        stats = dict(tight.sched.stats)
        reqs = list(tight.submitted)
        spill_used = tight.sched.load_stats()["kv_spill_used_bytes"]
    finally:
        tight.close()
    equal = [unified[tuple(r.prompt_ids)].output_ids == r.output_ids
             for r in reqs]
    faults = []
    if any(r["status"] != 200 for r in results) or any(r.error
                                                       for r in reqs):
        faults.append("a request failed")
    if stats["spill_resumes"] < 1:
        faults.append(f"no spill resume ({stats['preemptions']} "
                      f"preemptions)")
    if promoted_prefill["calls"] or promoted_prefill["flash_prefill"]:
        faults.append(f"promoted jobs were prefilled: {promoted_prefill}")
    if not all(equal):
        faults.append(f"streams differ from the roomy run's: {equal}")
    if spill_used:
        faults.append(f"{spill_used} spill bytes held at the end")
    if faults:
        raise AssertionError(f"serve_disagg spill: {'; '.join(faults)}")
    return dict(num_pages=DISAGG_PAGES, kv_spill_mb=DISAGG_SPILL_MB,
                wall_s=wall, streams_equal=True,
                preemptions=stats["preemptions"],
                spill_resumes=stats["spill_resumes"],
                spilled=stats.get("kv_spill_spilled", 0),
                over_budget=stats.get("kv_spill_over_budget", 0),
                recompute_preemptions=stats["preemptions"]
                - stats.get("kv_spill_spilled", 0),
                prefill_dispatches=stats["prefill_dispatches"],
                prefill_chunks=stats["prefill_chunks"],
                promoted_job_prefill=promoted_prefill, launches=launches)


def _tier_bits(got, want):
    """Keys of ``want``'s arrays whose bytes ``got`` does not carry."""
    import torch
    bad = []
    for key in ("k", "v", "k_s", "v_s"):
        if want.get(key) is None:
            continue
        a = torch.as_tensor(got[key]).cpu().contiguous()
        b = torch.as_tensor(want[key]).cpu().contiguous()
        if a.shape != b.shape or not torch.equal(a.view(torch.uint8),
                                                 b.view(torch.uint8)):
            bad.append(key)
    return bad


def _tier_import_readings(core, payload, n_imp, name):
    """Import the first ``n_imp`` pages of a tier payload into pages of a
    throwaway state of ``core`` (``import_pages_kv``, host seconds with the
    device synchronized, best of 3), export them again and hold them to
    the payload's bit for bit. Returns (ms, bytes moved)."""
    import torch
    state = core.init_state()
    pages = list(range(n_imp, 0, -1))
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core.import_pages_kv(state, pages, payload, n_pages=n_imp)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        best = s if best is None else min(best, s)
    back = core.export_slot_kv(state, pages, n_imp * core.page_size)
    want = {key: None if payload.get(key) is None
            else torch.as_tensor(payload[key])[:, :n_imp]
            for key in ("k", "v", "k_s", "v_s")}
    bad = _tier_bits(back, want)
    if bad or int(state.cache.lengths.abs().sum()) != 0:
        raise KernelMismatch(name, {"pages_differ": bad,
                                    "lengths_written": bool(
                                        state.cache.lengths.abs().sum())})
    nbytes = sum(want[key].numel() * want[key].element_size()
                 for key in want if want[key] is not None)
    del state
    return best * 1e3, nbytes


def _first_divergence(a, b):
    """The first position where two token streams differ (None: equal)."""
    if list(a) == list(b):
        return None
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _tier_case(dev, cfg, params, tok, unified, total, kv_quant):
    """Case 5, on one pool: the prefix-addressed host tier. Wave 1 into
    DISAGG_PAGES pages with ``kv_tier=prefix``: decode growth spills
    victims into the tier and every stream finishes equal to the roomy
    (unified) run's. Each victim's prompt is sent again, and the first's
    once more under the other sampling (seeded or greedy): each promotes
    the covered span from host RAM and prefills only the tail (``n -
    covered`` tokens dispatched, ``kv_tier_hit_tokens`` the covered ones,
    its opening page in the hot set), and ``flash_prefill`` (the tail) and
    the decode kernel launch for it. The import of the covered pages is
    timed and round-trips bit for bit; then the disk run: the entry in a
    tier with a disk budget and RAM for one entry, written behind, its RAM
    copy demoted by a second admission, checked out from its file (bit for
    bit) and imported from there (the files in a temporary directory
    removed at the end). Last the oracle: the same wave (the same grouped
    prefill, TIER_ORACLE_WAVE_TOKENS tokens each) into a roomy pool with
    the device prefix cache on, then each promoted request's own: a cache
    hit over the same span, from the same chunk boundary, whose stream
    each promoted one must equal. Against the unified stream (one chunk,
    no boundary) the promoted one is compared and not held: a chunk
    boundary changes the shapes of the tail's bf16 products, so near-ties
    may part. The returning requests decode TIER_RETURN_TOKENS tokens."""
    import shutil
    import tempfile
    from generativeaiexamples_tpu_torch.engine.kv_tier import (PrefixKVTier,
                                                               payload_nbytes)
    from generativeaiexamples_tpu_torch.engine.prefix_cache import (
        chain_hashes)
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    decode_key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                  else "ragged_paged_attention")
    first, _ = _disagg_traffic(False)
    core = _disagg_core(dev, cfg, params, "decode", kv_quant,
                        num_pages=DISAGG_PAGES, kv_spill_mb=DISAGG_SPILL_MB,
                        kv_tier="prefix")
    tight = _Worker(core, tok)
    sched, ps = tight.sched, core.page_size
    folder = tempfile.mkdtemp(prefix="serve_disagg_tier_")
    faults, promoted, readings = [], [], {}

    def sender(worker):
        def send(spec):
            i, text, tokens, chat, kw = spec
            return _request(worker.base, i, text, tokens, chat, False, **kw)
        return send

    try:
        send = sender(tight)
        k.reset_launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            results = [f.result() for f in _wave(pool, tight, first, send)]
        wave_s = time.perf_counter() - t0
        _add_launches(total, _launch_window(k))
        reqs = list(tight.submitted)
        victims = [(spec, r) for spec, r in zip(first, reqs)
                   if r.spill_resumes]
        if any(r["status"] != 200 for r in results) or any(r.error
                                                           for r in reqs):
            faults.append("a request of the wave failed")
        if not victims:
            faults.append(f"no spill resume ({sched.stats['preemptions']} "
                          f"preemptions)")
        if not all(unified[tuple(r.prompt_ids)].output_ids == r.output_ids
                   for r in reqs):
            faults.append("the wave's streams differ from the unified run's")
        hot = sched.load_stats()["kv_tier_hot"]
        specs = [(i, text, TIER_RETURN_TOKENS, chat, kw)
                 for (i, text, _, chat, kw), _ in victims]
        if victims:
            i, text, tokens, chat, kw = specs[0]
            specs.append((i, text, tokens, chat, dict(
                kw, temperature=0.7 if kw["temperature"] == 0.0 else 0.0)))
        t0 = time.perf_counter()
        for n_spec, spec in enumerate(specs if not faults else []):
            before = dict(sched.stats)
            n = len(tight.submitted)
            k.reset_launch_counts()
            got = send(spec)
            launches = _launch_window(k)
            _add_launches(total, launches)
            r3 = tight.submitted[n]
            back = dict(
                i=spec[0], greedy=spec[4]["temperature"] == 0.0,
                variant=n_spec == len(victims), status=got["status"],
                prompt_tokens=len(r3.prompt_ids),
                covered_tokens=r3.tier_hit_tokens,
                prefill_tokens=(sched.stats["prefill_tokens"]
                                - before["prefill_tokens"]),
                kv_tier_hit_tokens=(sched.stats["kv_tier_hit_tokens"]
                                    - before["kv_tier_hit_tokens"]),
                import_host_s=r3.kv_import_s,
                in_hot_set=sched.prefix_key_hex(r3.prompt_ids) in hot,
                flash_prefill=launches["flash_prefill"],
                decode_launches=launches[decode_key])
            if not back["variant"]:
                back["unified_first_divergence"] = _first_divergence(
                    r3.output_ids, unified[tuple(r3.prompt_ids)]
                    .output_ids[:len(r3.output_ids)])
            promoted.append((spec, r3, back))
            if (back["status"] != 200 or r3.error
                    or back["covered_tokens"] <= 0
                    or back["prefill_tokens"] != (back["prompt_tokens"]
                                                  - back["covered_tokens"])
                    or back["kv_tier_hit_tokens"] != back["covered_tokens"]
                    or not back["in_hot_set"] or back["flash_prefill"] < 1
                    or back["decode_launches"] < 1):
                faults.append(f"promotion {back}")
        returns_s = time.perf_counter() - t0
        if promoted and not faults:
            tier = sched._tier
            r = promoted[0][1]
            covered = promoted[0][2]["covered_tokens"]
            hashes = chain_hashes(list(r.prompt_ids), ps,
                                  seed=f"{sched._cache_seed}|")
            key, depth = tier.probe(hashes)
            payload = tier.checkout(key)
            try:
                ram_ms, nbytes = _tier_import_readings(
                    core, payload, covered // ps, f"tier {kv_quant} RAM")
                # the disk run: RAM for one entry, a disk budget
                entry = payload_nbytes(payload)
                dstats = {}
                disk = PrefixKVTier(int(entry * 1.5),
                                    disk_budget_bytes=4 * entry,
                                    disk_dir=folder, stats=dstats)
                try:
                    t1 = time.perf_counter()
                    disk.admit("entry", payload)
                    disk.contribute("entry", hashes[:depth], payload,
                                    tokens=depth * ps)
                    disk.release("entry")
                    _wait_for(lambda: disk.disk_used_bytes > 0,
                              "the tier's disk copy", timeout=120)
                    write_s = time.perf_counter() - t1
                    # a second admission of the same size demotes it
                    disk.admit("second", dict(payload))
                    t1 = time.perf_counter()
                    hit = disk.probe(hashes)
                    loaded = disk.checkout(hit[0]) if hit else None
                    load_s = time.perf_counter() - t1
                    if (loaded is None or dstats["kv_tier_demoted"] != 1
                            or dstats["kv_tier_disk_load"] != 1):
                        raise AssertionError(f"serve_disagg tier disk: no "
                                             f"promotion from disk {dstats}")
                    bad = _tier_bits(loaded, payload)
                    if bad:
                        raise KernelMismatch(f"tier {kv_quant} disk",
                                             {"differ": bad})
                    disk_ms, _ = _tier_import_readings(
                        core, loaded, covered // ps, f"tier {kv_quant} disk")
                    disk.checkin(hit[0])
                    disk.release("second", outcome="dropped")
                    files = sorted(os.listdir(folder))
                    disk_bytes = disk.disk_used_bytes
                finally:
                    disk.close()
            finally:
                tier.checkin(key)
            readings = dict(
                covered_tokens=covered, covered_pages=covered // ps,
                entry_pages=depth, payload_bytes=nbytes,
                entry_bytes=entry, import_ms=ram_ms,
                import_gb_s=nbytes / ram_ms / 1e6,
                gather_bound_ms=2 * nbytes / PEAK_BYTES * 1e3,
                disk=dict(write_behind_s=write_s, checkout_s=load_s,
                          import_ms=disk_ms, file_bytes=disk_bytes,
                          files=len(files), pages_bit_equal=True))
        live = sched._tier.live_refs()
        if live:
            faults.append(f"{live} tier pins held at the end")
        stats = dict(sched.stats)
    finally:
        tight.close()
        shutil.rmtree(folder, ignore_errors=True)
    if faults:
        raise AssertionError(f"serve_disagg tier {kv_quant}: "
                             f"{'; '.join(faults)}")
    t0 = time.perf_counter()
    oracle = _Worker(serving_core(
        dev, cfg, params, kv_quant, role="decode", spec_decode="off",
        mixed_phase_dispatch="off", decode_width_ladder="off",
        prefix_cache="on"), tok)
    try:
        send = sender(oracle)
        k.reset_launch_counts()
        replay = [(i, text, TIER_ORACLE_WAVE_TOKENS, chat, kw)
                  for i, text, _, chat, kw in first]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            [f.result() for f in _wave(pool, oracle, replay, send)]
        for spec, r3, back in promoted:
            n = len(oracle.submitted)
            send(spec)
            o = oracle.submitted[n]
            back["oracle_hit_tokens"] = o.prefix_hit_tokens
            back["equal"] = o.output_ids == r3.output_ids
            if (o.error or not back["equal"]
                    or o.prefix_hit_tokens != back["covered_tokens"]):
                faults.append(f"promotion against the cache hit {back}")
        _add_launches(total, _launch_window(k))
    finally:
        oracle.close()
    oracle_s = time.perf_counter() - t0
    if faults:
        raise AssertionError(f"serve_disagg tier {kv_quant}: "
                             f"{'; '.join(faults)}")
    return dict(kv_quant=kv_quant, num_pages=DISAGG_PAGES, wave_s=wave_s,
                returns_s=returns_s, oracle_s=oracle_s,
                wave_streams_equal=True,
                promoted_equal_cache_hit=True,
                preemptions=stats["preemptions"],
                spill_resumes=stats["spill_resumes"],
                contributed=stats["kv_tier_contributed"],
                retained=stats["kv_tier_retained"],
                promoted=stats["kv_tier_promoted"],
                returns=[back for _, _, back in promoted],
                readings=readings)


def _page_check(core, payload, name):
    """Import ``payload`` into pages of a throwaway state of ``core`` in
    reverse order, export them again: every byte must come back (the
    import's page placement and the export's gather). Returns (state,
    pages); raises KernelMismatch."""
    import torch
    state = core.init_state()
    n = int(payload["n_pages"])
    pages = list(range(n, 0, -1))
    core.import_slot_kv(state, 0, pages, payload)
    back = core.export_slot_kv(state, pages, payload["length"])
    bad = {}
    for key in ("k", "v", "k_s", "v_s"):
        if payload.get(key) is None:
            continue
        got, want = back[key], payload[key].to(back[key].device)
        if not torch.equal(got.view(torch.uint8), want.contiguous()
                           .view(torch.uint8)):
            bad[key] = int((got != want).sum())
    if int(state.cache.lengths[0]) != int(payload["length"]):
        bad["length"] = int(state.cache.lengths[0])
    if bad:
        raise KernelMismatch(name, {"pages_differ": bad, "n_pages": n})
    return state, pages


def _kv_readings(dec, pre, tok, kv_quant):
    """Case 4 for one pool: the longest ``serve`` prompt (a 1,728-byte
    completion, 14 pages) prefilled by the prefill worker into a
    device-native payload, then each step of its journey timed: the
    device gather and scatter (CUDA events, beside 3.35 TB/s for the
    bytes they read and write), the copy to the host, the frame's encode
    and decode (host, crc32 per segment), and the import from the decoded
    host payload (upload and scatter, synchronized); the pages round-trip
    bit for bit."""
    import torch
    from generativeaiexamples_tpu_torch.core import kv_wire
    from generativeaiexamples_tpu_torch.engine import kv_cache
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    r = Request(prompt_ids=tok.encode(PROMPT_TEXT * 12, add_bos=True),
                prefill_only=True, max_tokens=8, temperature=0.0)
    pre.sched.submit(r)
    _wait_for(lambda: r.finished_at is not None, "the readings' prefill")
    payload = r.handoff
    state, pages = _page_check(dec.core, payload, "serve_disagg pages")
    nbytes = sum(payload[key].numel() * payload[key].element_size()
                 for key in ("k", "v", "k_s", "v_s")
                 if payload.get(key) is not None)
    ids = torch.tensor(pages, device=state.cache.k.device)
    P = dec.core.num_pages
    gather_ms = time_ms(lambda: kv_cache.export_pages(state.cache, ids, P))
    L = dec.core.model_cfg.n_layers
    flat = [None if payload.get(key) is None else
            payload[key].reshape((-1,) + tuple(payload[key].shape[2:]))
            for key in ("k", "v", "k_s", "v_s")]
    scatter_ms = time_ms(lambda: kv_cache.import_pages(
        state.cache, ids, P, 0, payload["length"], *flat))

    def host_s(fn, reps=3):
        best = None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            best = s if best is None else min(best, s)
        return best, out

    fetch_s, _ = host_s(lambda: [payload[key].cpu() for key in
                                 ("k", "v", "k_s", "v_s")
                                 if payload.get(key) is not None])
    encode_s, frame = host_s(lambda: kv_wire.encode_kv_frames(payload))
    decode_s, decoded = host_s(lambda: kv_wire.decode_kv_frames(frame))
    import_s, _ = host_s(lambda: dec.core.import_slot_kv(state, 0, pages,
                                                         decoded))
    bound = 2 * nbytes / PEAK_BYTES * 1e3
    del state
    gb = lambda s: nbytes / s / 1e9
    return dict(
        kv_quant=kv_quant, tokens=len(r.prompt_ids),
        n_pages=payload["n_pages"],
        token_rows=payload["n_pages"] * dec.core.page_size,
        payload_bytes=nbytes, frame_bytes=len(frame),
        pages_round_trip="bit-equal",
        gather_ms=gather_ms, scatter_ms=scatter_ms,
        gather_scatter_bound_ms=bound,
        gather_share_of_bound=bound / gather_ms,
        scatter_share_of_bound=bound / scatter_ms,
        fetch_ms=fetch_s * 1e3, fetch_gb_s=gb(fetch_s),
        encode_ms=encode_s * 1e3, encode_gb_s=gb(encode_s),
        decode_ms=decode_s * 1e3, decode_gb_s=gb(decode_s),
        import_ms=import_s * 1e3, import_gb_s=gb(import_s),
        export_issue_ms=payload["export_s"] * 1e3)


def _ttft_readings(dec, pre):
    """The longest prompt's TTFT alone, from the client's POST to the
    server's first-token stamp (the servers run in this process, so one
    clock): unified on the decode worker (a completion), then through
    /v1/kv/prefill and /v1/kv/handoff, with the prefill worker's own
    submit -> first token and submit -> export, and the decode worker's
    import host seconds. Random weights under the byte tokenizer may
    stream no text for a while, so the stamps, not the client's first
    content, are read."""
    text = PROMPT_TEXT * 12
    body = {"prompt": text, "max_tokens": 8, "temperature": 0.0, "seed": 1}
    n = len(dec.submitted)
    t0 = time.perf_counter()
    status, _, _ = _post(dec.base + "/v1/completions",
                         json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
    u = dec.submitted[n]
    unified = u.first_token_at - t0
    t0 = time.perf_counter()
    frame, prefill_s = _kv_prefill_post(pre.base, 1, text, 8, False)
    m = len(dec.submitted)
    _kv_handoff_post(dec.base, frame)
    p, h = pre.submitted[-1], dec.submitted[m]
    return dict(
        prompt_tokens=len(u.prompt_ids), status=status,
        unified_ttft_s=unified,
        unified_server_ttft_s=u.first_token_at - u.submitted_at,
        handoff_ttft_s=h.first_token_at - t0,
        handoff_over_unified=(h.first_token_at - t0) / unified,
        prefill_post_s=prefill_s,
        prefill_worker_ttft_s=p.first_token_at - p.submitted_at,
        prefill_worker_export_s=p.finished_at - p.submitted_at,
        decode_worker_ttft_s=h.first_token_at - h.submitted_at,
        decode_worker_import_host_s=h.kv_import_s,
        frame_bytes=len(frame))


def phase_serve_disagg(dev, cfg, params):
    """llama3-8b at full width and depth, bf16 weights (``draw_8b``'s,
    shared), the byte tokenizer: workers each with its own pool of 8 slots
    of 2,048 behind the stdlib server, rows independent of timing
    (speculation, the mixed dispatch, the width ladder and the prefix
    cache off; waves admitted together in a fixed order):

    1. handoff: ``serve``'s traffic (decoders at 96 tokens, the late prompts
       and a json_object chat) unified on a ``role=decode`` worker, then
       through a ``role=prefill`` worker's ``/v1/kv/prefill`` (frames) and
       the decode worker's ``/v1/kv/handoff``: every stream equal to its
       unified one, greedy and seeded; the prefill worker makes no decode
       dispatch and no ``ragged_paged_attention`` launch, the decode worker
       no ``flash_prefill`` launch; then over the int8 pool (no json chat);
    2. evacuation: a seeded stream pulled through
       ``GET /v1/kv/evacuation/<rid>`` from the decode worker (per-step)
       and from one running ``decode_multistep=8`` at K 2 (a block in
       flight at the pull), each resumed on a peer: the joined text and the
       resumed ids equal the unevacuated stream's;
    3. spill: the decoders into DISAGG_PAGES pages with the spill pool
       armed: spill resumes, no prefill for a promoted job, the streams
       equal the roomy (unified) run's; then the same with the
       prefix-addressed tier (``_tier_case``, on both pools): each spill
       victim's prompt sent again (greedy and seeded) promotes its
       covered span and prefills only the tail, equal to a device
       prefix-cache hit over the same span, and a disk run demotes the
       entry to a file and promotes it from there bit for bit;
    4. readings: each request's frame bytes, export, encode, decode and
       import ms and GB/s; the longest prompt's gather and scatter against
       3.35 TB/s, copy, codec and import per pool, with its pages
       round-tripping bit for bit; its TTFT through the handoff against
       unified.

    The launch counts are set to 0 just before each run and read just
    after; returns their sum over the phase."""
    import torch
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    total, seconds, out = {}, {}, {}
    t0 = time.perf_counter()
    handoff, unified, pre, dec = _handoff_case(dev, cfg, params, tok, "none",
                                               total)
    seconds["handoff"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        out["evacuation"] = _evacuation_case(dev, cfg, params, tok, dec,
                                             total)
        seconds["evacuation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        readings = {"none": _kv_readings(dec, pre, tok, "none")}
        out["ttft"] = _ttft_readings(dec, pre)
        seconds["readings"] = time.perf_counter() - t0
    finally:
        pre.close()
        dec.close()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["spill"] = _spill_case(dev, cfg, params, tok, unified, total)
    seconds["spill"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["tier"] = {"none": _tier_case(dev, cfg, params, tok, unified, total,
                                      "none")}
    seconds["tier"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    handoff8, unified8, pre8, dec8 = _handoff_case(dev, cfg, params, tok,
                                                   "int8", total)
    try:
        readings["int8"] = _kv_readings(dec8, pre8, tok, "int8")
    finally:
        pre8.close()
        dec8.close()
    seconds["handoff_int8"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["tier"]["int8"] = _tier_case(dev, cfg, params, tok, unified8, total,
                                     "int8")
    seconds["tier_int8"] = time.perf_counter() - t0
    emit("serve_disagg", model="llama3-8b", handoff=handoff,
         handoff_int8=handoff8, readings=readings, seconds=seconds, **out)
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _disagg_parity_run(dev, name):
    """One check of ``parity_disagg`` at llama3-8b width, 2 layers, f32, by
    hand-driven schedulers (no HTTP): ``handoff`` (a 14-page prompt and a
    2-page one, greedy and seeded, prefilled by a prefill-role scheduler,
    their pages round-tripped through a throwaway pool, imported by a
    decode-role one: streams equal that scheduler's unified ones) or
    ``evacuation`` (a seeded stream evacuated once 8 tokens came, with the
    dispatches in flight drained first, and resumed on a peer: equal to
    the unevacuated stream)."""
    import dataclasses
    import torch
    from generativeaiexamples_tpu_torch.engine.scheduler import (Request,
                                                                 Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype="float32")
    params = llama.init_params(torch.Generator(device=dev).manual_seed(4),
                               cfg, device=dev)
    tok = ByteTokenizer()

    def sched(role):
        return Scheduler(_disagg_core(dev, cfg, params, role,
                                      eos_id=tok.eos_id), tok)

    prompts = [tok.encode(PROMPT_TEXT * 12, add_bos=True),
               tok.encode(PROMPT_TEXT, add_bos=True)]
    # 64 tokens: the dispatches in flight at the evacuation (up to
    # pipeline_depth x K steps past the host's view) end short of it
    kws = [dict(max_tokens=64, temperature=0.0),
           dict(max_tokens=64, temperature=0.7, seed=3)]
    if name == "handoff":
        dec = sched("decode")
        refs = _drive(dec, [Request(prompt_ids=list(p), **kw)
                            for p, kw in zip(prompts, kws)])
        rps = _drive(sched("prefill"), [
            Request(prompt_ids=list(p), prefill_only=True, **kw)
            for p, kw in zip(prompts, kws)])
        for rp in rps:
            _page_check(dec.core, rp.handoff, "parity_disagg")
        rds = [Request(prompt_ids=list(rp.handoff["prompt_ids"]), **kw)
               for rp, kw in zip(rps, kws)]
        for rd, rp in zip(rds, rps):
            dec.submit_prefilled(rd, rp.handoff)
        t0 = time.perf_counter()
        while not all(r.finished_at for r in rds):
            if time.perf_counter() - t0 > 600:
                raise AssertionError("handoffs unfinished after 600 s")
            dec._tick()
        got = [r.output_ids for r in rds]
        want = [r.output_ids for r in refs]
    else:
        peer = sched("decode")
        (ref,) = _drive(peer, [Request(prompt_ids=list(prompts[1]),
                                       **kws[1])])
        src = sched("decode")
        r = Request(prompt_ids=list(prompts[1]), **kws[1])
        src.submit(r)
        while r.completion_tokens < 8 and r.finished_at is None:
            src._tick()
        src.request_evacuation(wait_s=0.0)
        while src._evac_reqs:
            src._tick()
        payload = src.take_evacuated(r.request_id)
        if payload is None or r.finish_reason != "evacuated":
            raise AssertionError(f"parity_disagg: no snapshot "
                                 f"({r.finish_reason})")
        rd = Request(prompt_ids=list(payload["prompt_ids"]), **kws[1])
        peer.submit_prefilled(rd, payload)
        while rd.finished_at is None:
            peer._tick()
        got, want = [rd.output_ids], [ref.output_ids]
    if got != want or any(not ids for ids in want):
        raise KernelMismatch("parity_disagg", {
            "case": name, "equal": [a == b for a, b in zip(got, want)],
            "tokens": [len(a) for a in got]})
    return {"case": name, "tokens": [len(a) for a in got]}


def parity_disagg_cases(dev):
    """``parity_disagg``'s checks as thunks (the planted faults read them):
    ``handoff`` and ``evacuation``."""
    return {name: (lambda name=name: _disagg_parity_run(dev, name))
            for name in ("handoff", "evacuation")}


def phase_parity_disagg(dev):
    """Every case of ``parity_disagg_cases``, each raising on a mismatch."""
    readings = {name: fn() for name, fn in parity_disagg_cases(dev).items()}
    emit("parity_disagg", ok=True, streams_equal=True,
         pages_round_trip="bit-equal", runs=readings)


def phase_serve_prefix(dev, cfg, params, kv_quant="none"):
    """The prefix cache at full llama3-8b behind the HTTP server, with the
    reference's defaults: chat requests over one 1,536-byte context (64- to
    256-byte questions, 64 tokens, temperature 0 and 0.7). Request 0 alone
    (cold); requests 1 to 7 once its first token is out (cache hits while
    it decodes, riding mixed dispatches); after all finish, requests 8 to
    11 at once (hits with no decoder live: a grouped prefill through
    flash_prefill). Admission waits until each wave's requests have all
    arrived, so a wave is admitted in one pass. Launch and dispatch counts
    are set to 0 just before the requests and read just after; every
    request must answer 200 and hit exactly what ``_cap_shared`` gives for
    its prompt. Returns the launches."""
    import torch
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    tok = ByteTokenizer()
    core = serving_core(dev, cfg, params, kv_quant)
    warmup_s = core.warmup()
    sched = Scheduler(core, tok)
    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)

    def ask(i):
        return _request(base, i, CONTEXT_TEXT + QUESTIONS[i], 64, True,
                        i % 2 == 0, 0.0 if i % 2 == 0 else 0.7)

    arrived = _gate_admission(sched)

    def wave(pool, ids):
        arrived.clear()
        futs = [pool.submit(ask, i) for i in ids]
        _wait_for(lambda: len(submitted) > ids[-1], "a wave did not arrive")
        arrived.set()
        sched._wake.set()
        return futs

    sched.submit = recording_submit
    torch.cuda.reset_peak_memory_stats()
    httpd, thread = serve_in_thread(sched, "llama3-8b-random")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health.get("prefix_cache") is not True:
            raise AssertionError(f"/health reports {health}")
        k.reset_launch_counts()
        for key in sched.stats:
            sched.stats[key] = 0
        core.sample_calls = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(ask, 0)]
            _wait_for(lambda: (submitted and submitted[0].first_token_at)
                      or futs[0].done(), "no first token of the cold request")
            futs += wave(pool, range(1, 8))
            results = [f.result() for f in futs]
            at_late = dict(sched.stats)
            results += [f.result() for f in wave(pool, range(8, 12))]
        wall = time.perf_counter() - t0
        launches = k.launch_counts()
        stats = dict(sched.stats)
        health = sched.load_stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=30)
    for r in results:
        del r["text"]
        if r["status"] != 200 or not r["finish_reason"] or not r["usage"]:
            raise AssertionError(f"request failed: {r}")
    if len(submitted) != 12 or any(r.error or not r.first_token_at
                                   for r in submitted):
        raise AssertionError("a request got no first token or failed: "
                             f"{[r.error for r in submitted]}")
    # what _cap_shared allows each prompt: the full pages it shares with
    # the cold prompt (the questions differ from their first byte on)
    ps, cold = core.page_size, submitted[0].prompt_ids
    per_request = []
    for i, req in enumerate(submitted):
        ids = req.prompt_ids
        common = next((j for j, (a, b) in enumerate(zip(ids, cold))
                       if a != b), min(len(ids), len(cold)))
        want = 0 if i == 0 else sched._cap_shared(
            len(ids), min(common, len(cold)) // ps * ps)
        per_request.append({
            "prompt_tokens": len(ids), "prefix_hit_tokens":
            req.prefix_hit_tokens, "cap_shared": want,
            "server_ttft_s": req.first_token_at - req.submitted_at})
        if req.prefix_hit_tokens != want:
            raise AssertionError(f"request {i} hit {req.prefix_hit_tokens} "
                                 f"tokens; _cap_shared gives {want}")
    L = cfg.n_layers
    decode_key = ("ragged_paged_attention_int8" if kv_quant == "int8"
                  else "ragged_paged_attention")
    need_flash = L * stats["prefill_dispatches"]
    need_decode = L * stats["decode_steps"]
    if (launches["flash_prefill"] < need_flash or need_flash == 0
            or launches[decode_key] < need_decode or need_decode == 0):
        raise AssertionError(f"serving did not run through the kernels: "
                             f"launches {launches}, dispatches {stats}")
    # the 7 warm requests arrive while one slot decodes (a ramp): they take
    # a grouped prefill (or, past the hold's budget, mixed dispatches)
    if (at_late["mixed_dispatches"] + at_late["prefill_dispatches"] < 2
            or stats["prefill_dispatches"] <= at_late["prefill_dispatches"]):
        raise AssertionError(f"the warm requests rode no dispatch of their "
                             f"own, or the late ones no grouped prefill: "
                             f"{at_late}, {stats}")
    _check_loop("serve_prefix", stats, core, launches, sampled=True,
                ramp=False)
    ttft = [r["server_ttft_s"] for r in per_request]
    gen = sum(r["usage"]["completion_tokens"] for r in results)
    emit("serve_prefix" + ("" if kv_quant == "none" else "_" + kv_quant),
         model="llama3-8b", n_layers=L, dtype="bfloat16", kv_quant=kv_quant,
         weights="random, torch.Generator seed 0", context_bytes=len(
             CONTEXT_TEXT), requests=results, per_request=per_request,
         server_ttft_cold_s=ttft[0],
         server_ttft_cold_predicted_max_s=0.2,
         server_ttft_warm_mixed_s=ttft[1:8],
         server_ttft_warm_grouped_s=ttft[8:], completion_tokens=gen,
         wall_s=wall, gen_tok_s=gen / wall, dispatches=stats,
         dispatches_before_late=at_late, launches=launches,
         prefix_hit_frac=health["prefix_hit_frac"],
         prefix_cached_pages=health["prefix_cached_pages"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         **_loop_fields(stats, core, warmup_s, launches))
    return launches


def validates(value, schema) -> bool:
    """Whether ``value`` meets ``schema`` in the subset the grammars
    compile (types, enum, const, anyOf, string lengths, array bounds,
    fixed properties with required ones): a check independent of the
    grammar compiler."""
    if "const" in schema:
        return value == schema["const"]
    if "anyOf" in schema or "oneOf" in schema:
        return any(validates(value, o)
                   for o in schema.get("anyOf") or schema.get("oneOf"))
    if "enum" in schema:
        return any(value == v and type(value) == type(v)
                   for v in schema["enum"])
    t = schema.get("type")
    if t == "string":
        return (isinstance(value, str)
                and schema.get("minLength", 0) <= len(value)
                <= schema.get("maxLength", 10 ** 9))
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "array":
        return (isinstance(value, list)
                and schema.get("minItems", 0) <= len(value)
                <= schema.get("maxItems", 10 ** 9)
                and all(validates(v, schema.get("items", {}))
                        for v in value))
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        return (isinstance(value, dict)
                and all(r in value for r in schema.get("required", []))
                and all(k in props and validates(v, props[k])
                        for k, v in value.items()))
    return True


# serve_tools' traffic: (name, body, constrained kind); sent at once, each
# with its own seed (the admission order sorts by prompt and seed)
def _tools_traffic():
    ask = [{"role": "user", "content": "Plan a three-day trip to Oslo and "
                                       "report it as the schema asks."}]
    weather = [{"role": "user", "content": "What is the weather in Bergen?"}]
    schema = {"type": "json_schema",
              "json_schema": {"name": "trip", "schema": SMOKE_SCHEMA}}
    return [
        ("schema", {"messages": ask, "max_tokens": 96, "temperature": 0.0,
                    "seed": 1, "response_format": schema}, "schema"),
        ("schema_stream", {"messages": ask, "max_tokens": 96,
                           "temperature": 0.7, "seed": 7, "stream": True,
                           "response_format": schema}, "schema"),
        ("tool_forced", {"messages": weather, "max_tokens": 96,
                         "temperature": 0.0, "seed": 2, "tools": SMOKE_TOOLS,
                         "tool_choice": {"type": "function", "function": {
                             "name": "get_weather"}}}, "tool"),
        ("tool_auto", {"messages": weather, "max_tokens": 32,
                       "temperature": 0.0, "seed": 4, "tools": SMOKE_TOOLS,
                       "tool_choice": "auto"}, None),
        ("logprobs", {"messages": [{"role": "user", "content": PROMPT_TEXT}],
                      "max_tokens": 32, "temperature": 0.0, "seed": 5,
                      "logprobs": True, "top_logprobs": 5}, None),
        ("n2", {"messages": [{"role": "user", "content": "Two answers, "
                                                        "please."}],
                "max_tokens": 32, "temperature": 0.8, "seed": 11, "n": 2},
         None),
        ("plain_greedy", {"messages": [{"role": "user",
                                        "content": PROMPT_TEXT * 2}],
                          "max_tokens": 32, "temperature": 0.0, "seed": 6},
         None),
        ("plain_sampled", {"prompt": PROMPT_TEXT * 3, "max_tokens": 32,
                           "temperature": 0.7, "seed": 3}, None)]


def _tools_request(base, body):
    """POST one request; (status, body or the stream's chunks)."""
    url = base + ("/v1/chat/completions" if "messages" in body
                  else "/v1/completions")
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read().decode()
        status = resp.status
    if not body.get("stream"):
        return status, json.loads(raw)
    lines = [ln[len("data: "):] for ln in raw.splitlines()
             if ln.startswith("data: ")]
    if lines[-1] != "[DONE]":
        raise AssertionError("serve_tools: a stream without [DONE]")
    return status, [json.loads(ln) for ln in lines[:-1]]


def _tools_checks(name, body, kind, status, reply):
    """Every reply answers 200; a constrained one parses and validates
    under its schema or tool; a logprobs one has an entry a token."""
    if status != 200:
        raise AssertionError(f"serve_tools {name}: status {status}")
    if body.get("stream"):
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in reply)
        finish = reply[-1]["choices"][0]["finish_reason"]
    else:
        choice = reply["choices"][0]
        finish = choice["finish_reason"]
        text = (choice["message"]["content"] if "message" in choice
                else choice["text"]) or ""
        if len(reply["choices"]) != body.get("n", 1):
            raise AssertionError(f"serve_tools {name}: "
                                 f"{len(reply['choices'])} choices")
    if kind == "schema" and not validates(json.loads(text), SMOKE_SCHEMA):
        raise AssertionError(f"serve_tools {name}: {text!r} does not "
                             f"validate")
    if kind == "tool":
        call = reply["choices"][0]["message"]["tool_calls"][0]["function"]
        params = SMOKE_TOOLS[0]["function"]["parameters"]
        if (finish != "tool_calls" or call["name"] != "get_weather"
                or not validates(json.loads(call["arguments"]), params)):
            raise AssertionError(f"serve_tools {name}: tool call {call}")
    if body.get("logprobs"):
        content = reply["choices"][0]["logprobs"]["content"]
        if len(content) != reply["usage"]["completion_tokens"] or any(
                len(c["top_logprobs"]) != 5 for c in content[1:]):
            raise AssertionError(f"serve_tools {name}: {len(content)} "
                                 f"logprob entries for "
                                 f"{reply['usage']['completion_tokens']}")
    return {"finish_reason": finish, "text_bytes": len(text.encode())}


def _tools_run(core, tok, plain):
    """One pass of serve_tools' traffic through the HTTP server over a
    new Scheduler on ``core`` (its own page allocator and prefix cache,
    decode state and speculation statistics), every request admitted in
    one pass in a fixed order and every result read at the backpressure
    point (``HostCopy.done`` False), so the dispatches are the same in
    every pass; ``plain`` runs the sampler and the mask as their plain
    versions on the card. Returns (launches, sampler launches by variant,
    streams by request, logprob_data by request, checks, fields)."""
    from generativeaiexamples_tpu_torch.engine import engine as eng
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.ops import sampling
    from generativeaiexamples_tpu_torch.ops.cuda import build

    sched = Scheduler(core, tok)
    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)
    sched.submit = recording_submit
    traffic = _tools_traffic()
    gate = _gate_admission(sched)
    gate.clear()
    admit = sched._admit

    def ordered_admit():
        # a fixed admission order: the pending queue sorted by prompt and
        # seed, whatever order the HTTP threads submitted in
        with sched._lock:
            jobs = sorted(sched._pending, key=lambda j: (
                j.request.prompt_ids, j.request.seed or 0,
                j.request.max_tokens))
            sched._pending.clear()
            sched._pending.extend(jobs)
        return admit()
    sched._admit = ordered_admit
    saved = (eng.HostCopy.done, sampling.kernels.sample_slots,
             sampling.grammar_kernels.grammar_mask)
    eng.HostCopy.done = lambda self: False
    if plain:
        sampling.kernels.sample_slots = sampling.sample_slots_plain
        sampling.grammar_kernels.grammar_mask = (
            lambda *a: sampling.pack_mask(sampling.grammar_mask_plain(*a)))
    httpd, thread = serve_in_thread(sched, "llama3-8b-random")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    n_reqs = sum(b.get("n", 1) for _, b, _ in traffic)
    try:
        build.reset_launch_counts()
        core.sample_calls = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(traffic)) as pool:
            futs = [pool.submit(_tools_request, base, body)
                    for _, body, _ in traffic]
            _wait_for(lambda: len(submitted) >= n_reqs,
                      "serve_tools' requests to arrive")
            gate.set()
            replies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches = build.launch_counts()
        variants = build.sampler_launches_by_variant()
        stats = dict(sched.stats)
    finally:
        (eng.HostCopy.done, sampling.kernels.sample_slots,
         sampling.grammar_kernels.grammar_mask) = saved
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=30)
    checks = {name: _tools_checks(name, body, kind, *reply)
              for (name, body, kind), reply in zip(traffic, replies)}
    attached = [r.grammar_attached for r in submitted
                if r.grammar is not None]
    if len(attached) != 3 or not all(attached):
        raise AssertionError(f"serve_tools: grammars attached {attached}")
    key = lambda r: repr((r.prompt_ids[-8:], r.seed, r.max_tokens))
    streams = {key(r): list(r.output_ids) for r in submitted}
    if len(streams) != n_reqs or any(r.error for r in submitted):
        raise AssertionError("serve_tools: requests collide or failed: "
                             f"{[r.error for r in submitted]}")
    logprobs = {key(r): list(r.logprob_data) for r in submitted
                if r.logprobs}
    fields = dict(wall_s=wall,
                  completion_tokens=sum(r.completion_tokens
                                        for r in submitted),
                  dispatches=stats, sample_calls=core.sample_calls)
    return launches, variants, streams, logprobs, checks, fields


def _logprob_faults(got, want, tol=1e-5):
    """Where two passes' ``logprob_data`` differ, request by request:
    token and top ids exact, logprobs and top logprobs within ``tol``
    (a missing logprob, the fused first token's, only where both miss
    it). Returns (faults, largest logprob difference)."""
    faults, err = [], 0.0
    for k, rows in got.items():
        other = want.get(k, [])
        if len(rows) != len(other):
            faults.append(f"{len(rows)} logprob entries against "
                          f"{len(other)}")
            continue
        for i, ((t, lp, top), (t2, lp2, top2)) in enumerate(
                zip(rows, other)):
            pairs = [(lp, lp2)] + [(a[1], b[1]) for a, b in
                                   zip(top or [], top2 or [])]
            ids = [a[0] for a in top or []], [b[0] for b in top2 or []]
            if t != t2 or ids[0] != ids[1]:
                faults.append(f"entry {i}: ids {t}, {ids[0]} against "
                              f"{t2}, {ids[1]}")
                continue
            if any((a is None) != (b is None) for a, b in pairs):
                faults.append(f"entry {i}: a logprob in one pass only")
                continue
            for a, b in pairs:
                if a is not None:
                    err = max(err, abs(a - b))
    if err > tol:
        faults.append(f"logprobs differ by {err} > {tol}")
    return faults, err


def phase_serve_tools(dev, cfg, params):
    """serve_tools: llama3-8b at full width (``params``, bf16) over the
    smoke's Llama-3-shaped BPE tokenizer, the engine's defaults on 12
    slots: two ``json_schema`` requests (one streamed), a forced tool
    call and a ``tool_choice: "auto"`` one, a ``logprobs`` +
    ``top_logprobs: 5`` one, an ``n = 2`` seeded one and two plain ones,
    sent at once. Every constrained reply parses and validates, every
    logprob list has an entry a token; ``grammar_mask`` and the sampler's
    mask, advance and top variants launch. Then the same traffic on the
    same core with the sampler and the mask as their plain versions on
    the card (no launch of either): every token stream equal, and the
    logprob request's ``logprob_data`` too (token and top ids exact,
    logprobs within 1e-5). Returns the kernel pass's launches."""
    import torch
    tok = smoke_tokenizer()["tok"]
    core = serving_core(dev, cfg, params, batch=12, eos_id=tok.eos_id)
    t0 = time.perf_counter()
    core.ensure_token_bytes(tok)
    table_s = time.perf_counter() - t0
    warmup_s = core.warmup(tokenizer=tok)
    launches, variants, streams, lps, checks, fields = _tools_run(
        core, tok, plain=False)
    p_launches, p_variants, p_streams, p_lps, _, p_fields = _tools_run(
        core, tok, plain=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del core
    torch.cuda.empty_cache()
    faults = []
    for name in ("flash_prefill", "ragged_paged_attention", "grammar_mask"):
        if launches[name] < 1:
            faults.append(f"{name} never launched")
    for want in ("mask+advance", "top"):
        if not any(want in v and n > 0 for v, n in variants.items()):
            faults.append(f"no sample_slots launch with {want}")
    if launches["sample_slots"] != fields["sample_calls"]:
        faults.append(f"{launches['sample_slots']} sample_slots launches "
                      f"for {fields['sample_calls']} sampling calls")
    if p_launches["grammar_mask"] or p_launches["sample_slots"]:
        faults.append(f"the plain pass launched {p_launches}")
    differ = [k for k in streams if streams[k] != p_streams.get(k)]
    if differ:
        faults.append(f"{len(differ)} streams differ between the kernel "
                      f"and the plain pass")
    lp_faults, lp_err = _logprob_faults(lps, p_lps)
    if not lps or not any(top for rows in lps.values()
                          for _, _, top in rows):
        lp_faults.append("no top logprobs to compare")
    faults += [f"logprob_data: {f}" for f in lp_faults]
    if faults:
        raise AssertionError("serve_tools: " + "; ".join(faults))
    emit("serve_tools", model="llama3-8b", n_layers=cfg.n_layers,
         tokenizer="llama3-shaped BPE, seed 0", requests=checks,
         streams_equal_plain=True, logprob_entries_compared=sum(
             len(rows) for rows in lps.values()),
         logprob_max_abs_err_vs_plain=lp_err, launches=launches,
         sample_slots_by_variant=variants, plain_pass=p_fields,
         plain_sample_slots_by_variant=p_variants, warmup_s=warmup_s,
         token_byte_table_s=table_s, peak_mem_gb=peak, **fields)
    return launches


def phase_dense(dev, cfg, params, rows=8, T=2048, steps=32):
    """The dense-cache API at full llama3-8b: one prefill of ``rows``
    prompts of 64 to 512 tokens (last_only) into a T-row cache, then
    ``steps`` greedy decode steps, through flash_prefill and ragged_decode
    with the stock config (``attn_impl="auto"``), launch counts set to 0
    just before, read just after."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    lens = [64 + (512 - 64) * i // (rows - 1) for i in range(rows)]
    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, 256, (rows, max(lens)), generator=g,
                           device=dev, dtype=torch.int32)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    cache = llama.KVCache.create(cfg, rows, T, device=dev)
    torch.cuda.synchronize()
    k.reset_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = llama.prefill(params, cfg, tokens, cache,
                                      torch.zeros_like(seq), seq,
                                      last_only=True)
        tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = llama.decode_step(params, cfg, tok, cache)
            tok = logits.argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches = k.launch_counts()
    L = cfg.n_layers
    if launches["flash_prefill"] < L or launches["ragged_decode"] < L * steps:
        raise AssertionError(f"dense API did not run through the kernels: "
                             f"launches {launches}")
    toks = torch.stack(out, dim=1)
    if (not torch.isfinite(logits).all() or logits.shape != (rows, cfg.vocab_size)
            or toks.min() < 0 or toks.max() >= cfg.vocab_size
            or cache.lengths.tolist() != [n + steps for n in lens]):
        raise AssertionError("dense API gave wrong shapes, lengths or "
                             "non-finite logits")
    fields = dict(model="llama3-8b", n_layers=L, dtype="bfloat16", rows=rows,
                  cache_rows=T, prompt_lens=lens, decode_steps=steps,
                  prefill_s=prefill_s, decode_ms_per_step=decode_s * 1e3 / steps,
                  launches=launches,
                  cache_bytes=2 * cache.k.numel() * cache.k.element_size())
    emit("dense", **fields)
    return launches


# ---------------------------------------------------------------------------
# A checkpoint on disk: the HF safetensors layout and a Llama-3 tokenizer
# ---------------------------------------------------------------------------

# safetensors dtype names of the torch dtypes a checkpoint holds
ST_DTYPES = {"torch.float32": "F32", "torch.float16": "F16",
             "torch.bfloat16": "BF16", "torch.int8": "I8",
             "torch.int32": "I32", "torch.int64": "I64", "torch.uint8": "U8",
             "torch.bool": "BOOL"}


def write_safetensors(path, tensors, metadata=None) -> int:
    """Write ``tensors`` (name -> torch tensor on any device) as one
    safetensors file, in order, each copied to the host as it is written
    (bf16 as its raw 16 bits). Returns the bytes written."""
    import struct
    import torch
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[str(t.dtype)],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)       # the data section starts aligned
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            fh.write(t.numpy().tobytes())
    return 8 + len(raw) + offset


def hf_state(cfg, params):
    """HF ``LlamaForCausalLM`` names -> the port's model-dtype leaves, in
    the order a checkpoint stores them."""
    from generativeaiexamples_tpu_torch.models import llama
    state = {"model.embed_tokens.weight": params["embed"]}
    for i, layer in enumerate(params["layers"]):
        for key, hf in llama.HF_LAYER_KEYS.items():
            state[f"model.layers.{i}.{hf}"] = layer[key]
    state["model.norm.weight"] = params["final_norm"]
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = params["lm_head"]
    return state


def hf_config(cfg) -> dict:
    """``config.json`` of a Llama-3 checkpoint of ``cfg``."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "intermediate_size": cfg.hidden_dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "tie_word_embeddings": cfg.tie_embeddings,
            "max_position_embeddings": 8192, "hidden_act": "silu",
            "bos_token_id": 128000, "eos_token_id": 128001,
            "torch_dtype": cfg.dtype, "rope_scaling": None}


def write_hf_checkpoint(directory, cfg, params, shards=4) -> int:
    """``config.json``, ``shards`` ``model-0000k-of-0000n.safetensors``
    files of about equal bytes and ``model.safetensors.index.json``, as
    ``save_pretrained`` lays out a sharded checkpoint. Returns the bytes of
    the shards."""
    state = hf_state(cfg, params)
    total = sum(t.numel() * t.element_size() for t in state.values())
    groups, size = [[]], 0
    for name, t in state.items():
        if size >= total * len(groups) / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(name)
        size += t.numel() * t.element_size()
    weight_map, written = {}, 0
    for k, names in enumerate(groups, 1):
        fname = f"model-{k:05d}-of-{len(groups):05d}.safetensors"
        written += write_safetensors(os.path.join(directory, fname),
                                     {n: state[n] for n in names},
                                     {"format": "pt"})
        weight_map.update({n: fname for n in names})
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as fh:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, fh)
    with open(os.path.join(directory, "config.json"), "w") as fh:
        json.dump(hf_config(cfg), fh, indent=1)
    return written


# Llama-3's special tokens by id (the rest of 128,000-128,255 are reserved)
LLAMA3_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
                   6: "<|start_header_id|>", 7: "<|end_header_id|>",
                   9: "<|eot_id|>"}
LLAMA3_MERGES = 127_744          # 256 bytes + merges = 128,000 entries
CORPUS_FILES = ("SURVEY.md", "PAPER.md", "PAPERS.md", "SNIPPETS.md")


def markdown_corpus() -> str:
    """The repo's reference notes (Markdown), the learned merges' text."""
    parts = []
    for name in CORPUS_FILES:
        path = os.path.join(HERE, name)
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as fh:
                parts.append(fh.read())
    return "\n\n".join(parts)


def _learned_merges(corpus, b2u, n, per_round=64):
    """Up to ``n`` merges learned from ``corpus``: words split roughly as
    Llama-3 splits them, byte-pair counts, and per round the most frequent
    pairs that share no symbol merged everywhere (ties by the pair)."""
    import collections
    import re
    words = collections.Counter(re.findall(
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\w]?[^\W\d_]+|\d{1,3}"
        r"| ?[^\s\w]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+", corpus))
    words = [[list(b2u[b] for b in w.encode()), c] for w, c in words.items()]
    merges = []
    while len(merges) < n:
        pairs = collections.Counter()
        for syms, c in words:
            for pair in zip(syms, syms[1:]):
                pairs[pair] += c
        ranked = sorted((p for p, c in pairs.items() if c >= 2),
                        key=lambda p: (-pairs[p], p))
        chosen, used = {}, set()
        for a, b in ranked:
            if len(chosen) == min(per_round, n - len(merges)):
                break
            if a not in used and b not in used:
                chosen[(a, b)] = a + b
                used.update((a, b))
        if not chosen:
            break
        merges += list(chosen)
        for w in words:
            syms, out, i = w[0], [], 0
            while i < len(syms):
                if i + 1 < len(syms) and (syms[i], syms[i + 1]) in chosen:
                    out.append(syms[i] + syms[i + 1])
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            w[0] = out
    return merges


def llama3_tokenizer_json(corpus, n_merges=LLAMA3_MERGES, seed=0,
                          learned=2048) -> dict:
    """A ``tokenizer.json`` shaped as Meta's Llama-3 one, made from a seed:
    the GPT-2 byte alphabet as ids 0-255, ``n_merges`` merges (up to
    ``learned`` of them learned from ``corpus``, the rest seeded
    concatenations of two entries into a new one of at most 16 bytes), 256
    added specials after the regular entries (Llama-3's names at its
    offsets, the rest reserved), Llama-3's Split pattern before a
    ByteLevel without its regex, ``ignore_merges`` and a ByteLevel
    decoder."""
    import random
    from generativeaiexamples_tpu_torch.engine import native_tokenizer as nt
    b2u = nt.bytes_to_unicode()
    tokens = [b2u[b] for b in sorted(b2u, key=lambda b: ord(b2u[b]))]
    vocab = {t: i for i, t in enumerate(tokens)}
    merges = []
    for a, b in _learned_merges(corpus, b2u, min(learned, n_merges)):
        if a + b not in vocab:
            vocab[a + b] = len(tokens)
            tokens.append(a + b)
            merges.append(f"{a} {b}")
    rng = random.Random(seed)
    while len(merges) < n_merges:
        a, b = tokens[rng.randrange(len(tokens))], tokens[
            rng.randrange(len(tokens))]
        if len(a) + len(b) <= 16 and a + b not in vocab:
            vocab[a + b] = len(tokens)
            tokens.append(a + b)
            merges.append(f"{a} {b}")
    added, reserved = [], 0
    for k in range(256):
        name = LLAMA3_SPECIALS.get(k)
        if name is None:
            name, reserved = f"<|reserved_special_token_{reserved}|>", \
                reserved + 1
        added.append({"id": len(tokens) + k, "content": name,
                      "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True})
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": nt._LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }


# serve_ckpt's chat requests: ASCII, accented Latin, CJK and emoji
CKPT_CHATS = (
    "Summarize how a paged KV cache shares pages between requests.",
    "Résumé en français : le cache de préfixes évite de recalculer les "
    "pages déjà vues — naïve café, Zürich, señor.",
    "日本語と中文：分页缓存如何在请求之间共享页面？请简要说明。",
    "Emoji check 🚀🔥👍🏽 with symbols ⚡☃ — then say done.",
)
CKPT_TOKENS = 32


def _serve_chats(sched, tok, name, chats, sampled=()):
    """Serve ``chats`` (greedy, one after another, streamed and not in
    turn) and then ``sampled`` (the chain server's temperature 0.2 / top-p
    0.7, all at once) behind the HTTP server; launch counts set to 0 just
    before, read just after. Every request answers 200, reports as
    ``prompt_tokens`` the length of ``apply_chat_template``, and its text
    equals ``tok.decode`` of its ids. A correctness check, not a rate: the
    checkpoint phases time ``serve``'s traffic (``_traffic_texts``).
    Returns (the greedy requests' ids, launches, fields)."""
    import torch
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k

    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)

    sched.submit = recording_submit
    httpd, thread = serve_in_thread(sched, name)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        k.reset_launch_counts()
        results = [_request(base, i, c, CKPT_TOKENS, chat=True,
                            stream=i % 2 == 0, temperature=0.0)
                   for i, c in enumerate(chats)]
        with concurrent.futures.ThreadPoolExecutor(len(sampled) or 1) as ex:
            results += list(ex.map(
                lambda ic: _request(base, ic[0], ic[1], CKPT_TOKENS,
                                    chat=True, stream=True, temperature=0.2,
                                    top_p=0.7), enumerate(sampled)))
        launches = k.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=30)
    by_prompt = {}
    for r in submitted:
        by_prompt.setdefault(tuple(r.prompt_ids), []).append(r)
    greedy_ids = []
    for i, (content, r) in enumerate(zip(list(chats) + list(sampled),
                                          results)):
        ids = tok.apply_chat_template([{"role": "user", "content": content}])
        req = by_prompt[tuple(ids)].pop(0)
        usage = r["usage"] or {}
        if (r["status"] != 200 or req.error or not r["finish_reason"]
                or usage.get("prompt_tokens") != len(ids)
                or usage.get("completion_tokens") != len(req.output_ids)
                or r["text"] != tok.decode(req.output_ids)):
            raise AssertionError(
                f"{name}: request {i} answered {r['status']} "
                f"{r['finish_reason']} {usage} (chat template {len(ids)} "
                f"ids, {len(req.output_ids)} generated, error {req.error}); "
                f"text {r['text']!r} against decode "
                f"{tok.decode(req.output_ids)!r}")
        if i < len(chats):
            greedy_ids.append(list(req.output_ids))
    return greedy_ids, launches, dict(
        chat_requests=len(submitted),
        chat_completion_tokens=sum(len(r.output_ids) for r in submitted),
        chat_prompt_tokens=[len(r.prompt_ids) for r in submitted],
        chat_launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _traffic_texts(tok):
    """``serve``'s staggered traffic in ``tok``'s tokens: prompts as many
    tokens long as ``serve``'s are bytes (the byte tokenizer's), each a
    prefix of one periodic text as ``PROMPT_TEXT * n`` is, so that chunks,
    the ramp, the mixed dispatch and the prefix cache see the same
    shapes. Returns (the decoders' prompts, the late prompt)."""
    per = len(PROMPT_TEXT)
    need = per * max(DECODERS + (LATE_PROMPT,))
    ids = tok.encode(PROMPT_TEXT * max(DECODERS) * 12)
    if len(ids) < need:
        raise AssertionError(f"_traffic_texts: {len(ids)} tokens, "
                             f"{need} needed")

    def text(n):
        t = tok.decode(ids[:n])
        while len(tok.encode(t)) > n:
            t = t[:-1]
        return t

    return [text(per * n) for n in DECODERS], text(per * LATE_PROMPT)


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _tokenizer_cost(tok, corpus):
    """Host cost of the native tokenizer: tokens/s encoding a ~100 KB
    document, and microseconds a chat template of one CKPT_CHATS message."""
    doc = (corpus * (1 + 100_000 // max(1, len(corpus))))[:100_000]
    t0 = time.perf_counter()
    ids = tok.encode(doc)
    enc_s = time.perf_counter() - t0
    if tok.decode(ids) != doc:
        raise AssertionError("the native tokenizer does not round-trip the "
                             "100 KB document")
    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        tok.apply_chat_template([{"role": "user",
                                  "content": CKPT_CHATS[i % 4]}])
    return dict(doc_bytes=len(doc.encode()), doc_tokens=len(ids),
                encode_s=enc_s, encode_tok_s=len(ids) / enc_s,
                chat_template_us=(time.perf_counter() - t0) / n * 1e6)


def phase_serve_ckpt(dev, cfg, params, smi):
    """The checkpoint path at full llama3-8b (``serve_ckpt``, then
    ``serve_ckpt_w8``). Writes ``params`` (bf16) as an HF directory under
    build/ (removed at the end): ``config.json`` with Llama-3-8B's values,
    four safetensors shards with their index, and a Llama-3-shaped
    ``tokenizer.json`` from seed 0. Loads it with ``load_hf_dir``: every
    tensor bit-equal to ``params``; serves the four ``CKPT_CHATS`` greedy
    and then at the chain server's settings through the HTTP server with
    ``get_tokenizer(dir)``, through flash_prefill, ragged_paged_attention
    and sample_slots, the greedy ids equal to a Scheduler over the
    in-memory ``params``; then times ``serve``'s traffic in the
    checkpoint's tokens over the loaded weights (``serve_ckpt_traffic``).
    Then loads it with ``quant="int8"``: every q and s bit-equal to
    ``quantize`` of the in-memory matrix, the load's peak within the int8
    set plus two of its largest bf16 matrices, and two chats through
    ``w8a16_gemm`` (its run of ``serve``'s traffic was cut to keep the
    smoke's time: its dispatches and launches were ``serve_w8``'s).
    Returns the launches of the four paths."""
    import shutil
    import torch
    from generativeaiexamples_tpu_torch.engine.native_tokenizer import (
        NativeBPETokenizer)
    from generativeaiexamples_tpu_torch.engine.scheduler import (
        Request, Scheduler)
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.models import hf_loader
    from generativeaiexamples_tpu_torch.ops import quant as quant_ops

    directory = os.path.join(HERE, "build", "serve_ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    state = hf_state(cfg, params)
    need = sum(t.numel() * t.element_size() for t in state.values())
    free = shutil.disk_usage(directory).free
    if free < need + 4e9:
        raise AssertionError(f"serve_ckpt: {free / 1e9:.2f} GB free under "
                             f"build/, the checkpoint needs {need / 1e9:.2f} "
                             f"GB and a 4 GB margin")
    try:
        corpus = markdown_corpus()
        smoke = smoke_tokenizer()
        shutil.copy(os.path.join(smoke["dir"], "tokenizer.json"), directory)
        tok_s = smoke["seconds"]["tokenizer_json_s"]
        t0 = time.perf_counter()
        written = write_hf_checkpoint(directory, cfg, params)
        write_s = time.perf_counter() - t0

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lcfg, loaded = hf_loader.load_hf_dir(directory, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        if lcfg != cfg:
            raise AssertionError(f"serve_ckpt: config.json gave {lcfg}, "
                                 f"not {cfg}")
        unequal = [n for n, t in hf_state(lcfg, loaded).items()
                   if not _bits_equal(t, state[n])]
        if unequal:
            raise AssertionError(f"serve_ckpt: {len(unequal)} tensors load "
                                 f"unequal to the written ones: "
                                 f"{unequal[:4]}")
        t0 = time.perf_counter()
        tok = get_tokenizer(directory)
        tok_load_s = time.perf_counter() - t0
        if not (isinstance(tok, NativeBPETokenizer) and tok.ignore_merges
                and (tok.vocab_size, tok.bos_id, tok.eos_id)
                == (128_256, 128_000, 128_009)):
            raise AssertionError(f"serve_ckpt: tokenizer {type(tok)} vocab "
                                 f"{tok.vocab_size} bos {tok.bos_id} eos "
                                 f"{tok.eos_id}")
        core = serving_core(dev, lcfg, loaded, eos_id=tok.eos_id)
        warmup_s = core.warmup()
        greedy, launches, fields = _serve_chats(
            Scheduler(core, tok), tok, "llama3-8b-ckpt", CKPT_CHATS,
            sampled=CKPT_CHATS)
        if min(launches[k] for k in ("flash_prefill", "ragged_paged_attention",
                                     "sample_slots")) <= 0:
            raise AssertionError(f"serve_ckpt did not run through the "
                                 f"kernels: {launches}")
        del core
        gc.collect()
        torch.cuda.empty_cache()
        # serve's traffic over the loaded weights and the checkpoint's
        # tokenizer: its rate and TTFT compare with serve's
        texts = _traffic_texts(tok)
        tlaunches, core = phase_serve(dev, lcfg, loaded, tok=tok, texts=texts,
                                      name="serve_ckpt_traffic")
        del core, loaded
        gc.collect()
        torch.cuda.empty_cache()
        # the same greedy chats, one after another, over the in-memory
        # weights
        ref = Scheduler(serving_core(dev, cfg, params, eos_id=tok.eos_id),
                        tok)
        ref.start()
        try:
            want = []
            for content in CKPT_CHATS:
                req = Request(prompt_ids=tok.apply_chat_template(
                    [{"role": "user", "content": content}]),
                    max_tokens=CKPT_TOKENS, temperature=0.0)
                ref.submit(req)
                "".join(ref.iter_text(req))
                want.append(list(req.output_ids))
        finally:
            ref.stop()
        if greedy != want:
            raise AssertionError(f"serve_ckpt: greedy ids {greedy} differ "
                                 f"from the in-memory model's {want}")
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        emit("serve_ckpt", nvidia_smi=smi, model="llama3-8b",
             n_layers=lcfg.n_layers, dtype=lcfg.dtype,
             checkpoint_bytes=written, shards=4,
             weights="random, torch.Generator seed 0, written as safetensors",
             tokenizer="Llama-3-shaped, seed 0: 128,000 entries, 256 "
                       "specials, ignore_merges",
             tokenizer_write_s=tok_s, tokenizer_load_s=tok_load_s,
             write_s=write_s, load_s=load_s, load_gb_s=written / load_s / 1e9,
             load_peak_gb=load_peak, warmup_s=warmup_s,
             greedy_equal_in_memory=True,
             **fields, **_tokenizer_cost(tok, corpus))
        paths = {"serve_ckpt": launches, "serve_ckpt_traffic": tlaunches}

        # int8, quantized matrix by matrix as it is read
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, qloaded = hf_loader.load_hf_dir(directory, device=dev,
                                           quant="int8")
        torch.cuda.synchronize()
        qload_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_bytes
        qstate = hf_state(lcfg, qloaded)
        int8_bytes = sum(t.q.numel() + 4 * t.s.numel()
                         if isinstance(t, quant_ops.QTensor)
                         else t.numel() * t.element_size()
                         for t in qstate.values())
        largest = max(t.numel() * t.element_size() for t in state.values())
        limit = int8_bytes + 2 * largest
        if peak > limit:
            raise AssertionError(f"serve_ckpt_w8: the load peaked "
                                 f"{peak / 1e9:.3f} GB above what it found, "
                                 f"past the int8 set plus two bf16 matrices "
                                 f"({limit / 1e9:.3f} GB)")
        for name, t in qstate.items():
            if isinstance(t, quant_ops.QTensor):
                want_q = quant_ops.quantize(state[name])
                ok = (torch.equal(t.q, want_q.q)
                      and _bits_equal(t.s, want_q.s))
                del want_q
            else:
                ok = _bits_equal(t, state[name])
            if not ok:
                raise AssertionError(f"serve_ckpt_w8: {name} differs from "
                                     f"quantize of the in-memory matrix")
        core = serving_core(dev, lcfg, qloaded, quant="int8",
                            eos_id=tok.eos_id)
        _, qlaunches, qfields = _serve_chats(
            Scheduler(core, tok), tok, "llama3-8b-ckpt-w8", CKPT_CHATS[:2])
        if qlaunches["w8a16_gemm"] <= 0:
            raise AssertionError(f"serve_ckpt_w8 did not run w8a16_gemm: "
                                 f"{qlaunches}")
        emit("serve_ckpt_w8", nvidia_smi=smi, load_s=qload_s,
             load_gb_s=written / qload_s / 1e9,
             load_peak_above_resident_gb=peak / 1e9,
             load_peak_limit_gb=limit / 1e9, int8_set_gb=int8_bytes / 1e9,
             largest_bf16_matrix_gb=largest / 1e9, **qfields)
        paths["serve_ckpt_w8"] = qlaunches
        del core, qloaded, qstate
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def profile_decode(core, ctx: int = 1000, steps: int = 8,
                   spec_width=None, sampling=None, adapters=0, multi_m=0,
                   ranges=()):
    """Where a full-batch decode dispatch spends its time: 8 slots at
    ``ctx`` tokens, ``spec_width`` wide steps (a ladder rung; the narrow
    step on a core without speculation), greedy or with ``sampling``
    (temperature, top_k, top_p; slot s seeded s), host clock per step,
    device time by kernel class and device operations a step
    (torch.profiler), after the serving run (not part of its counts).
    ``adapters``: slot s takes resident adapter slot s % (adapters + 1),
    the base model among them (``profile_lora``). ``multi_m``: one
    ``decode_multi`` dispatch of ``steps`` x ``multi_m`` steps, every slot
    carrying a stop string none of its tokens can match (the ring and the
    suspect lookup run, nothing pauses); the per-step figures are over
    its steps. ``ranges``: ``record_function`` names whose kernels count
    as a class of their own (``_device_ms_by_class``)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from generativeaiexamples_tpu_torch.engine.engine import PrefillItem

    state = core.init_state()
    alloc = core.new_allocator()
    table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
    items = []
    for s in range(core.batch):
        # budget and pages for the warm-up dispatch and the profiled one
        budget = max(4, 2 * core.spec_width) * steps * max(1, multi_m)
        pages = alloc.alloc(core.pages_for(ctx + budget))
        table[s, :len(pages)] = pages
        ids = [(s * 31 + i) % 256 for i in range(ctx)]
        temperature, top_k, top_p = sampling or (0.0, 0, 1.0)
        for start in range(0, ctx, core.chunk):
            chunk = ids[start:start + core.chunk]
            items.append(PrefillItem(
                chunk_ids=chunk, page_row=table[s], slot=s, start_pos=start,
                is_last=start + len(chunk) >= ctx, generated=1,
                max_gen=budget + 1, temperature=temperature, top_k=top_k,
                top_p=top_p, seed=s, adapter_ix=s % (adapters + 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(0, len(items), core.prefill_group_max):
        state, _ = core.prefill_group(state, items[g:g + core.prefill_group_max])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    dev_table = core.put_table(table)
    kw = {} if spec_width is None else {"spec_width": spec_width}

    def dispatch(state):
        if multi_m:
            return core.decode_multi(state, dev_table, steps, multi_m,
                                     stops=("\x00\x01",))
        return core.decode(state, dev_table, steps, **kw)

    state, _ = dispatch(state)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, out = dispatch(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps *= max(1, multi_m)
    emitted = int(out["emitted"].sum())
    classes, summed, top = _device_ms_by_class(
        prof, (("ragged_paged_attention", ("ragged_paged",)),
               ("w8a16_gemm", ("w8a16",)), ("lora", ("lora_shrink", "lora_expand")),
               ("matmul", MATMUL_KERNELS)), ranges)
    device_ms = sum(classes.values())
    device_ops = sum(1 for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA)
    return {"batch": core.batch, "context": ctx, "steps": steps,
            "spec_width": spec_width or 1, "tokens_emitted": emitted,
            "sampling": "greedy" if sampling is None else dict(zip(
                ("temperature", "top_k", "top_p"), sampling)),
            "device_ops_per_step": device_ops / steps,
            "ms_per_emitted_token": wall * 1e3 / max(1, emitted),
            "prefill_chunks": len(items), "prefill_s": prefill_s,
            "decode_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": device_ms / steps,
            "device_busy_share": device_ms / (wall * 1e3),
            "device_ms_per_step_by_class": {
                k: v / steps for k, v in classes.items()},
            "top_other_ms_per_step": [[n, ms / steps] for n, ms in top],
            "key_averages_self_device_ms_per_step": summed / steps}


def profile_w8(core, bf16_matmul_ms):
    """A narrow decode step with int8 weights (8 slots at 1,000 tokens,
    ``profile_decode``): the W8A16 GEMM's device ms a step against the
    bytes a step must read (every layer matrix, the head and their scales;
    the embedding is gathered, not read whole) over 3.35 TB/s, and
    against the bf16 step's matmul ms of the same run."""
    from generativeaiexamples_tpu_torch.ops import quant
    prof = profile_decode(core)
    read = sum(w.q.numel() + 4 * w.s.numel()
               for w in quant.weights(core.params)
               if w is not core.params["embed"])
    gemm_ms = prof["device_ms_per_step_by_class"]["w8a16_gemm"]
    bound_ms = read / PEAK_BYTES * 1e3
    return dict(prof, weight_bytes_read_a_step=read,
                gemm_bound_ms_a_step=bound_ms, gemm_ms_a_step=gemm_ms,
                gemm_share_of_bound=bound_ms / gemm_ms if gemm_ms else None,
                bf16_matmul_ms_a_step=bf16_matmul_ms)


CHAIN_SAMPLING = (0.2, 0, 0.7)     # the chain server's temperature, top_p


def profile_sampled(dev, cfg, params):
    """A decode dispatch at the chain server's settings beside the same
    dispatch greedy (``profile_decode``: 8 slots at 1,000 tokens, bf16
    pool) at W = 5, 4 steps each: device operations, host wall and device
    busy share a step. What the top-p path adds to a step. (The narrow
    pair was cut to keep the smoke's time, and the steps from 8 to 4 when
    ``serve_multi`` came.)"""
    import torch
    out = {}
    for rung, knobs, width in (("w5", {}, 5),):
        core = serving_core(dev, cfg, params, **knobs)
        for name, smp in (("greedy", None), ("chain", CHAIN_SAMPLING)):
            prof = profile_decode(core, steps=4, spec_width=width,
                                  sampling=smp)
            out[f"{rung}_{name}"] = {key: prof[key] for key in (
                "spec_width", "sampling", "device_ops_per_step",
                "decode_ms_per_step", "device_ms_per_step",
                "device_busy_share", "tokens_emitted")}
        out[f"{rung}_ops_added_by_sampling"] = (
            out[f"{rung}_chain"]["device_ops_per_step"]
            - out[f"{rung}_greedy"]["device_ops_per_step"])
        del core
        torch.cuda.empty_cache()
    return out


def _queue_probe(core, sched, spin_ms=200.0):
    """How far the host runs ahead of a busy card: host ms of calls made
    right behind a ``spin_ms`` spin kernel. A call that returns at once
    queued its work; one that takes the spin's time waited for the card
    (a sync, or a full launch queue)."""
    import numpy as np
    import torch
    cycles = _lag_cycles(spin_ms)
    table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)

    def behind(fn):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms

    return {"spin_ms": spin_ms,
            "decode_dispatch_ms": behind(lambda: core.decode(
                sched._state, sched._table_device(),
                core.cfg.decode_steps_per_dispatch)),
            "engine_upload_ms": behind(lambda: core.put_table(table)),
            "blocking_upload_ms": behind(
                lambda: torch.as_tensor(table, device=core.device))}


def _kv_pages_ranged():
    """Context that puts every page scatter and dense gather of the paged
    passes under a ``kv_pages`` profiler range."""
    import contextlib
    from torch.autograd.profiler import record_function
    from generativeaiexamples_tpu_torch.engine import kv_cache

    @contextlib.contextmanager
    def ranged():
        passes = {name: getattr(kv_cache, name)
                  for name in ("_scatter_pages", "_gather_dense",
                               "_write_rows")}

        def in_range(fn):
            def wrapped(*args, **kw):
                with record_function("kv_pages"):
                    return fn(*args, **kw)
            return wrapped

        try:
            for name, fn in passes.items():
                setattr(kv_cache, name, in_range(fn))
            yield
        finally:
            for name, fn in passes.items():
                setattr(kv_cache, name, fn)
    return ranged()


def profile_prefill(core, chunk: int = 512, rows: int = 8):
    """Where a grouped prefill dispatch spends its time: ``rows`` prompts of
    two chunks each; the first chunks go in one dispatch (warm-up), the
    second chunks (queries at 512..1023 over 1,024 keys) in one profiled
    dispatch. Host wall ms and device ms by class (torch.profiler): matmul,
    flash_prefill, the page scatter and dense K/V gather of every layer
    (with the int8 quantize and dequantize; ``kv_pages``), other."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from generativeaiexamples_tpu_torch.engine.engine import PrefillItem

    if rows > core.prefill_group_max or chunk > core.chunk:
        raise AssertionError("profile_prefill: group or chunk past the "
                             "engine's limits")
    state = core.init_state()
    alloc = core.new_allocator()
    table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
    prompts = []
    for s in range(rows):
        pages = alloc.alloc(core.pages_for(2 * chunk + 1))
        table[s, :len(pages)] = pages
        prompts.append([(s * 37 + i) % 256 for i in range(2 * chunk)])

    def group(half):
        return [PrefillItem(chunk_ids=p[half * chunk:(half + 1) * chunk],
                            page_row=table[s], slot=s,
                            start_pos=half * chunk, is_last=half == 1,
                            generated=1, max_gen=2, temperature=0.0)
                for s, p in enumerate(prompts)]

    state, _ = core.prefill_group(state, group(0))
    torch.cuda.synchronize()
    with _kv_pages_ranged(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = core.prefill_group(state, group(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes, summed, top = _device_ms_by_class(
        prof, (("flash_prefill", ("flash_prefill",)),
               ("matmul", MATMUL_KERNELS)), ranges=("kv_pages",))
    device_ms = sum(classes.values())
    return {"rows": rows, "chunk": chunk, "start_pos": chunk,
            "kv_dtype": str(state.cache.k.dtype).replace("torch.", ""),
            "host_wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "device_ms_by_class": classes,
            "flash_prefill_share_of_device": classes["flash_prefill"]
            / device_ms,
            "top_other_ms": top,
            "key_averages_self_device_ms": summed}


def profile_mixed(core, ctx: int = 1000, steps: int = 8):
    """A mixed dispatch against the two-dispatch pair doing the same work:
    8 slots decoding at ``ctx`` tokens (top verify width, uncapped) and 4
    prompts whose next chunk of 512 starts at 0/512/1,024/1,536 (their
    earlier chunks prefilled). Mixed: one ``decode_mixed`` of ``steps``
    steps with the 4 chunks in step 0; pair: ``prefill_group`` of the 4
    chunks, then ``decode`` of ``steps`` steps. Each is run once to warm
    and once under torch.profiler, each from a freshly prefilled state;
    host wall, device ms by class (ragged_paged_attention, flash_prefill,
    matmul, kv_pages: page writes and dense gathers), busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from generativeaiexamples_tpu_torch.engine.engine import PrefillItem

    n_dec, n_ch = 8, len(MIXED_STARTS)
    if core.batch < n_dec + n_ch or not core.mixed_supported:
        raise AssertionError("profile_mixed needs 12 slots and the mixed "
                             "dispatch on")

    def setup():
        state = core.init_state()
        alloc = core.new_allocator()
        table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
        items, chunks = [], []
        for s in range(n_dec):
            pages = alloc.alloc(core.pages_for(ctx + core.spec_width * steps))
            table[s, :len(pages)] = pages
            ids = [(s * 31 + i) % 256 for i in range(ctx)]
            for start in range(0, ctx, core.chunk):
                chunk = ids[start:start + core.chunk]
                items.append(PrefillItem(
                    chunk_ids=chunk, page_row=table[s], slot=s,
                    start_pos=start, is_last=start + len(chunk) >= ctx,
                    generated=1, max_gen=core.spec_width * steps + 1,
                    temperature=0.0))
        for c, start in enumerate(MIXED_STARTS):
            s = n_dec + c
            pages = alloc.alloc(core.max_pages_per_slot)
            table[s, :len(pages)] = pages
            ids = [(s * 37 + i) % 256 for i in range(start + core.chunk)]
            for pos in range(0, start + core.chunk, core.chunk):
                item = PrefillItem(chunk_ids=ids[pos:pos + core.chunk],
                                   page_row=table[s], slot=s, start_pos=pos)
                (chunks if pos == start else items).append(item)
        for g in range(0, len(items), core.prefill_group_max):
            state, _ = core.prefill_group(
                state, items[g:g + core.prefill_group_max])
        torch.cuda.synchronize()
        return state, core.put_table(table), chunks

    def mixed(state, table, chunks):
        core.decode_mixed(state, table, steps, chunks)

    def pair(state, table, chunks):
        core.prefill_group(state, chunks)
        core.decode(state, table, steps)

    res = {"decode_slots": n_dec, "context": ctx, "steps": steps,
           "spec_width": core.spec_width, "chunks": n_ch,
           "chunk_starts": list(MIXED_STARTS), "chunk": core.chunk,
           "kv_dtype": core.kv_dtype}
    for name, fn in (("mixed", mixed), ("two_dispatch", pair)):
        fn(*setup())                                   # warm
        args = setup()
        with _kv_pages_ranged(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        classes, summed, top = _device_ms_by_class(
            prof, (("ragged_paged_attention", ("ragged_paged",)),
                   ("flash_prefill", ("flash_prefill",)),
                   ("matmul", MATMUL_KERNELS)), ranges=("kv_pages",))
        device_ms = sum(classes.values())
        res[name] = {"host_wall_ms": wall * 1e3, "device_ms": device_ms,
                     "device_busy_share": device_ms / (wall * 1e3),
                     "device_ms_by_class": classes, "top_other_ms": top,
                     "key_averages_self_device_ms": summed}
        del args
    return res


MATMUL_KERNELS = ("gemm", "gemv", "nvjet", "cutlass", "sm90_xmma", "cublas")


def _device_ms_by_class(prof, classes, ranges=()):
    """Device ms of every kernel the profiler recorded, each counted once
    (device events only: an aten op's own device time repeats its
    kernels'), by class: the first of ``ranges`` (``record_function``
    names) above the op that launched the kernel, else the first
    ``(class, name parts)`` of ``classes`` with a part in the kernel's name,
    else "other". Also returns the sum of every ``key_averages`` entry's
    self device time, which counts a kernel and its launching op both, and
    the five kernels that take most of "other" with their ms."""
    from collections import Counter
    from torch.autograd import DeviceType
    events = prof.events()
    ranged = Counter()             # (range, kernel name) -> us
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        node = ev
        while node is not None and node.name not in ranges:
            node = node.cpu_parent
        if node is not None:
            for kern in ev.kernels:
                ranged[(node.name, kern.name)] += kern.duration
    by_name = Counter()
    for ev in events:
        if (ev.device_type == DeviceType.CUDA and ev.name not in ranges
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.name] += ev.time_range.elapsed_us()
    out = {name: 0.0 for name in (*ranges, *(c for c, _ in classes),
                                  "other")}
    other = Counter()
    for (rng, kname), us in ranged.items():
        out[rng] += us
        by_name[kname] -= us
    for kname, us in by_name.items():
        if us <= 0:              # every launch of it ran under a range
            continue
        low = kname.lower()
        cls = next((c for c, parts in classes
                    if any(p in low for p in parts)), "other")
        out[cls] += us
        if cls == "other":
            other[kname[:100]] += us
    if sum(out.values()) <= 0:
        raise AssertionError("profiler recorded no device time")
    summed = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)) or 0.0
                 for ev in prof.key_averages())
    top = [[name, us / 1e3] for name, us in other.most_common(5)]
    return {k: v / 1e3 for k, v in out.items()}, summed / 1e3, top


# Faults the kernel checks must catch, planted in a copy of the port:
# (name, csrc file, text, replacement, phases run). dropped_tile skips the
# 31st 64-token tile of the walk, which only the 2047-token rows reach (one
# tile in 32); dropped_split has the combine skip the last split of every
# (row, KV head); wrong_scale_slot reads the next token's scales in the
# int8 pool; ragged_causal_off_by_one hides each query's own key from it
# in the decode-side walk's tensor-core path; flash_dropped_tile skips the
# second KV tile of every flash_prefill walk that reaches it;
# flash_causal_off_by_one hides each query's own key from it;
# sampler_wrong_rotation changes one of threefry's rotation constants,
# sampler_counter_off_by_one draws entry i with counter i + 1,
# sampler_top_p_strict makes the top-p predicate mass > target (caught at
# top-p 0, where every mass ties the target of 0) and sampler_z_over_all
# sums z over every entry instead of the top-k survivors (caught where a
# row has both filters) in the sampling kernel; gemm_dropped_scale leaves
# the per-channel scale out of the W8A16 GEMM's bf16 epilogue,
# gemm_skipped_k_tile has its consumers skip the wgmma of the second 64
# of the contraction's depth (still releasing its stage),
# gemm_cluster_dropped_rank has the distributed-shared-memory reduction of
# its decode tiles skip rank 1's partials (caught where the plan splits the
# contraction across a cluster), gemm_f32_skipped_k_tile skips the first
# tile in its f32 instance and gemm_ring_guard_off removes the odd decode
# ring's wait for a slot's last release (caught by the late-ring case: a
# wrong result, or a wait that traps). grammar_flipped_bit flips one bit of every word
# of the grammar mask; grammar_row_dropped never walks the last row of
# each interleaved group of constrained rows; grammar_failsafe_off has the
# last block ignore the row's "any entry allowed" flag (EOS only at
# accepting states); grammar_scratch_kept has it read the flags without
# resetting them (caught by two_launches); sampler_mask_unconstrained has
# the sampler apply the mask to a row whose state is <= 0 (whose words
# are zero in the sampler's option cases and unwritten by the mask);
# sampler_advance_short leaves the last byte of the drawn token out of
# the sampler's DFA advance; sampler_top_tie_high has the sampler's top
# rows take a tie by the higher index.
# ---------------------------------------------------------------------------
# The retrieval half of the RAG path: encoders, the vector store, serve_rag
# ---------------------------------------------------------------------------

# the parity phase's texts: lengths from 3 to past 512 bytes (cut at the
# encoder's 512 positions), unicode, a repeated word
ENCODER_TEXTS = ("ü", "paged attention keeps pages",
                 "the reranker scores (query, passage) pairs " * 4,
                 PROMPT_TEXT, "page " * 40, PROMPT_TEXT * 4,
                 "Ünïcödé text with accents: café, naïve, façade.",
                 "a vector store holds one row a passage")
ENCODER_QUERY = "which pages does a request share?"
ENCODER_TOL = {"embed": 1e-4, "rerank": 1e-3, "ivf": 1e-5}
# the IVF case: a clustered corpus (as bench_ivf's), every cell probed so
# the top-10 must equal the brute force; a third of the rows deleted
IVF_PARITY = dict(n=20_000, dim=384, modes=32, nlist=64, queries=16)


def _encoder_parity_model():
    """e5-base's width (768, 12 heads, F 3,072), 2 layers, f32, with the
    rank head: weights on the CPU from a torch.Generator seeded 21."""
    import torch
    from generativeaiexamples_tpu_torch.models import bert
    cfg = bert.BertConfig(n_layers=2)
    return cfg, bert.init_params(torch.Generator().manual_seed(21), cfg,
                                 with_rank_head=True)


def _rows_on_cpu(fn, params, cfg, seqs, types=None):
    """``fn`` (``bert.embed`` or ``bert.rank_score``) on the CPU, one
    unpadded row a sequence: inputs built here, not by the encoder's own
    packing, so a fault there shows."""
    import numpy as np
    import torch
    out = []
    for i, seq in enumerate(seqs):
        tokens = torch.tensor([seq])
        mask = torch.ones_like(tokens, dtype=torch.bool)
        args = (tokens, mask) + ((torch.tensor([types[i]]),) if types else ())
        out.append(fn(params, cfg, *args)[0].numpy())
    return np.stack(out)


def _encoder_embed_case(dev):
    import numpy as np
    from generativeaiexamples_tpu_torch.encoders import Embedder
    from generativeaiexamples_tpu_torch.encoders.embedder import \
        PASSAGE_PREFIX
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import bert
    cfg, params = _encoder_parity_model()
    card = Embedder(cfg=cfg, params=params, device=dev, dtype="float32",
                    max_batch=4)
    got = card.embed_documents(list(ENCODER_TEXTS))
    tok = ByteTokenizer()
    want = _rows_on_cpu(bert.embed, params, cfg, [
        tok.encode(PASSAGE_PREFIX + t)[:cfg.max_positions]
        for t in ENCODER_TEXTS])
    err = float(np.abs(got - want).max()) if got.shape == want.shape else None
    reading = {"case": "embed", "rows": len(ENCODER_TEXTS),
               "max_abs_err": err, "tolerance": ENCODER_TOL["embed"],
               "finite": bool(np.isfinite(got).all())}
    if err is None or not reading["finite"] or err > ENCODER_TOL["embed"]:
        raise KernelMismatch("parity_encoders", reading)
    return reading


def _encoder_rerank_case(dev):
    import numpy as np
    from generativeaiexamples_tpu_torch.encoders import Reranker
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import bert
    cfg, params = _encoder_parity_model()
    card = Reranker(cfg=cfg, params=params, device=dev, dtype="float32",
                    max_batch=4)
    passages = list(ENCODER_TEXTS)
    got = card.score(ENCODER_QUERY, passages)
    ranked = card.rerank(ENCODER_QUERY, passages, top_n=len(passages))
    tok = ByteTokenizer()
    q = tok.encode(ENCODER_QUERY)[:cfg.max_positions // 2]
    seqs, types = [], []
    for p in passages:
        ids = tok.encode(p)[:cfg.max_positions - len(q) - 1]
        seqs.append(q + [0] + ids)
        types.append([0] * (len(q) + 1) + [1] * len(ids))
    want = _rows_on_cpu(bert.rank_score, params, cfg, seqs, types)
    tol = ENCODER_TOL["rerank"]
    err = float(np.abs(got - want).max())
    order = [i for i, _ in ranked]
    # the card's order, read in the CPU's scores, never rises by more
    # than the tolerance twice over (a swap only at a near-tie)
    order_ok = all(want[a] >= want[b] - 2 * tol
                   for a, b in zip(order, order[1:]))
    reading = {"case": "rerank", "pairs": len(passages), "max_abs_err": err,
               "tolerance": tol, "order": order,
               "cpu_order": [int(i) for i in np.argsort(-want)],
               "order_ok": order_ok}
    if not np.isfinite(got).all() or err > tol or not order_ok:
        raise KernelMismatch("parity_encoders", reading)
    return reading


def _encoder_ivf_case(dev):
    import numpy as np
    from generativeaiexamples_tpu_torch.retrieval import Document, VectorStore
    p = IVF_PARITY
    rng = np.random.default_rng(0)
    modes = rng.standard_normal((p["modes"], p["dim"])).astype(np.float32)
    emb = (modes[rng.integers(0, p["modes"], p["n"])] + 0.15
           * rng.standard_normal((p["n"], p["dim"])).astype(np.float32))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    store = VectorStore(p["dim"], index_type="ivf", nlist=p["nlist"],
                        nprobe=p["nlist"], device=dev)
    half = p["n"] // 2
    docs = [Document(content=str(i), metadata={"source": f"s{i % 3}"})
            for i in range(p["n"])]
    store.add(docs[:half], emb[:half])
    store.search(emb[0], top_k=10)            # the k-means build
    store.add(docs[half:], emb[half:])        # assigned incrementally
    store.delete_by_source(["s1"])
    live = np.array([i % 3 != 1 for i in range(p["n"])])
    queries = emb[rng.integers(0, p["n"], p["queries"])] + 0.05 * \
        rng.standard_normal((p["queries"], p["dim"])).astype(np.float32)
    mismatched, err, near_ties = [], 0.0, 0
    data = emb.astype(np.float64)
    tol = ENCODER_TOL["ivf"]
    for qi, q in enumerate(queries):
        hits = store.search(q, top_k=10)
        qd = q.astype(np.float64) / np.linalg.norm(q.astype(np.float64))
        scores = np.where(live, data @ qd, -np.inf)
        truth = np.argsort(-scores, kind="stable")[:10]
        got = np.array([int(d.content) for d, _ in hits])
        if len(got) != 10 or len(set(got)) != 10:
            mismatched.append(qi)
            continue
        err = max(err, max(abs(s - (scores[i] + 1) / 2)
                           for i, (_, s) in zip(got, hits)))
        if not np.array_equal(got, truth):
            # accepted only where each rank's score equals the brute
            # force's within the tolerance (a swap at a near-tie)
            if np.abs(scores[got] - scores[truth]).max() <= 2 * tol:
                near_ties += 1
            else:
                mismatched.append(qi)
    reading = {"case": "ivf", "rows": p["n"], "live_rows": int(live.sum()),
               "nlist": p["nlist"], "nprobe": p["nlist"],
               "queries": p["queries"], "mismatched_queries": mismatched,
               "near_tie_queries": near_ties, "max_score_err": float(err),
               "tolerance": ENCODER_TOL["ivf"],
               "cell_cap": int(store._grouped.shape[1])}
    if mismatched or err > tol:
        raise KernelMismatch("parity_encoders", reading)
    return reading


def parity_encoders_cases(dev):
    """``parity_encoders``'s checks as thunks (the planted faults read
    them): ``embed`` and ``rerank`` (the encoders on the card at e5-base's
    width, 2 layers, f32, against ``bert.embed`` / ``bert.rank_score`` on
    the CPU over inputs built here) and ``ivf`` (the IVF store on the card
    against a float64 numpy brute force)."""
    return {"embed": lambda: _encoder_embed_case(dev),
            "rerank": lambda: _encoder_rerank_case(dev),
            "ivf": lambda: _encoder_ivf_case(dev)}


def phase_parity_encoders(dev):
    """Every case of ``parity_encoders_cases``, each raising on a
    mismatch."""
    readings = {name: fn() for name, fn in parity_encoders_cases(dev).items()}
    emit("parity_encoders", ok=True, width="e5-base (768, 12 heads, F 3,072)",
         n_layers=2, dtype="float32", runs=readings)


RAG_QUERIES = ("How are the CUDA kernels built and checked on the card?",
               "What does the prefix cache share between requests?",
               "How does the scheduler admit and batch requests?",
               "Which metrics does the server export?")
RAG_PROMPT = ("Answer the question from this context only.\n\n"
              "{context}\n\nQuestion: {query}")
RAG_POSTS = 24          # concurrent /v1/embeddings requests
RAG_MAX_TOKENS = 32


def rag_corpus():
    """(path, text) of the repository's ``docs/*.md`` and ``SURVEY.md``."""
    import glob
    paths = sorted(glob.glob(os.path.join(HERE, "docs", "*.md")))
    paths.append(os.path.join(HERE, "SURVEY.md"))
    out = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            out.append((os.path.relpath(path, HERE), fh.read()))
    return out


def _rag_server_posts(emb, rer, texts):
    """``RAG_POSTS`` concurrent /v1/embeddings POSTs and one /v1/ranking
    against an EncoderServer over the phase's encoders: each reply's vector
    within bf16 noise of the direct call's, and fewer embed dispatches
    than requests."""
    import numpy as np
    from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
    from generativeaiexamples_tpu_torch.encoders.server import serve_in_thread
    _, httpd, thread = serve_in_thread(emb, rer)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        status, _, raw = _post(base + path, json.dumps(body).encode(),
                               {"Content-Type": "application/json"})
        if status != 200:
            raise AssertionError(f"{path} answered {status}: {raw[:300]}")
        return json.loads(raw)

    dispatches = REGISTRY.counter("embed_dispatches")
    fill = REGISTRY.histogram("embed_batch_fill")
    try:
        d0, f0 = dispatches.value, (fill.count, fill.sum)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(RAG_POSTS) as pool:
            replies = list(pool.map(lambda t: post(
                "/v1/embeddings", {"input": [t], "input_type": "query"}),
                texts))
        wall = time.perf_counter() - t0
        n_disp = dispatches.value - d0
        mean_fill = (fill.sum - f0[1]) / max(1, fill.count - f0[0])
        got = np.array([r["data"][0]["embedding"] for r in replies],
                       np.float32)
        want = emb.embed_queries(texts)
        cos = np.sum(got * want, axis=1)
        ranking = post("/v1/ranking", {
            "query": {"text": texts[0]},
            "passages": [{"text": t} for t in texts[:8]], "top_n": 3})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    logits = [r["logit"] for r in ranking["rankings"]]
    reading = dict(requests=RAG_POSTS, embed_dispatches=n_disp,
                   mean_batch_fill=mean_fill, wall_s=wall, min_cosine_to_direct=float(cos.min()),
                   ranking=ranking["rankings"])
    if (n_disp >= RAG_POSTS or n_disp < 1 or cos.min() < 0.99
            or len(logits) != 3 or logits != sorted(logits, reverse=True)):
        raise AssertionError(f"serve_rag's encoder server: {reading}")
    return reading


def phase_serve_rag(dev, cfg, params):
    """The north star's path on one card: the repository's Markdown split
    by ``TokenTextSplitter`` (the config's 510 / 200), embedded by the
    ``Embedder`` at full e5-base in bf16 with its micro-batcher on, held in
    the ``VectorStore``; each of ``RAG_QUERIES`` embedded, searched at
    ``nr_top_k`` (40), cut to ``top_k`` (4) by the ``Reranker`` (full
    e5-base with the rank head, bf16), its passages (cut to
    ``max_context_tokens``) put in a chat to llama3-8b (``cfg``) behind the
    engine's HTTP server (the defaults, greedy, 32 tokens). Every request
    must answer 200 with its top passage in its prompt and launch the
    engine's kernels; then ``RAG_POSTS`` concurrent /v1/embeddings
    requests to an ``EncoderServer`` must take fewer dispatches than
    requests. Returns the launches."""
    import numpy as np
    import torch
    from generativeaiexamples_tpu_torch.core.config import load_config
    from generativeaiexamples_tpu_torch.encoders import Embedder, Reranker
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    from generativeaiexamples_tpu_torch.retrieval import (Document,
                                                          TokenTextSplitter,
                                                          VectorStore)
    app = load_config(env={})        # the reference's defaults
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tok = ByteTokenizer()
    corpus = rag_corpus()
    t0 = time.perf_counter()
    splitter = TokenTextSplitter(app.text_splitter.chunk_size,
                                 app.text_splitter.chunk_overlap)
    chunks = [(src, c) for src, text in corpus for c in splitter.split(text)]
    split_s = time.perf_counter() - t0
    e5 = bert.BertConfig.e5_base()
    emb = Embedder(cfg=e5, device=dev, dtype="bfloat16", micro_window_s=(
        app.embeddings.microbatch_window_ms / 1e3))
    rer = Reranker(cfg=e5, device=dev, dtype="bfloat16", micro_window_s=(
        app.ranking.microbatch_window_ms / 1e3))
    encoder_bytes = sum(t.numel() * t.element_size() for enc in (emb, rer)
                        for t in _leaves(enc.params))
    emb.embed_documents(["warm up"])     # first calls: cuBLAS handles
    rer.score("warm", ["up"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = emb.embed_documents([c for _, c in chunks])
    ingest_embed_s = time.perf_counter() - t0
    if (vecs.shape != (len(chunks), e5.dim) or not np.isfinite(vecs).all()
            or np.abs(np.linalg.norm(vecs, axis=1) - 1).max() > 1e-4):
        raise AssertionError(f"serve_rag: embeddings {vecs.shape} not finite "
                             f"unit rows")
    store = VectorStore(e5.dim, index_type=app.vector_store.index_type,
                        nlist=app.vector_store.nlist,
                        nprobe=app.vector_store.nprobe, device=dev)
    t0 = time.perf_counter()
    store.add([Document(content=c, metadata={"source": src})
               for src, c in chunks], vecs)
    store_add_s = time.perf_counter() - t0
    for i in range(0, len(chunks), max(1, len(chunks) // 4)):
        (top, rel), = store.search(vecs[i], top_k=1)
        if top.content != chunks[i][1] or rel < 0.999:
            raise AssertionError(f"serve_rag: chunk {i} does not find itself "
                                 f"({rel})")

    core = serving_core(dev, cfg, params)
    warmup_s = core.warmup()
    sched = Scheduler(core, tok)
    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)

    sched.submit = recording_submit
    httpd, thread = serve_in_thread(sched, "llama3-8b-random")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    calls = []
    try:
        k.reset_launch_counts()
        for key in sched.stats:
            sched.stats[key] = 0
        for qi, query in enumerate(RAG_QUERIES):
            t_q = time.perf_counter()
            qv = emb.embed_queries([query])[0]
            t_s = time.perf_counter()
            hits = store.search(qv, top_k=app.retriever.nr_top_k,
                                score_threshold=app.retriever.score_threshold)
            t_r = time.perf_counter()
            ranked = rer.rerank(query, [d.content for d, _ in hits],
                                top_n=app.retriever.top_k)
            t_p = time.perf_counter()
            context = "\n\n".join(hits[i][0].content for i, _ in ranked)
            context = tok.decode(tok.encode(context)[
                :app.retriever.max_context_tokens])
            n_sub = len(submitted)
            reply = _request(base, qi, RAG_PROMPT.format(context=context,
                                                         query=query),
                             RAG_MAX_TOKENS, chat=True, stream=True,
                             temperature=0.0)
            req = submitted[n_sub] if len(submitted) > n_sub else None
            calls.append(dict(
                query=query, hits=len(hits), ranked=ranked,
                embed_ms=(t_s - t_q) * 1e3, search_ms=(t_r - t_s) * 1e3,
                rerank_ms=(t_p - t_r) * 1e3, context_bytes=len(context),
                status=reply["status"],
                finish_reason=reply["finish_reason"],
                usage=reply["usage"],
                query_to_first_token_s=(req.first_token_at - t_q
                                        if req and req.first_token_at
                                        else None),
                server_ttft_s=(req.first_token_at - req.submitted_at
                               if req and req.first_token_at else None),
                prompt_has_top_passage=bool(req) and hits[ranked[0][0]][
                    0].content[:200] in tok.decode(req.prompt_ids),
                _req=req, _context=context))
            if len(hits) < app.retriever.top_k:
                raise AssertionError(f"serve_rag: {len(hits)} hits for "
                                     f"{query!r}")
        launches = k.launch_counts()
        stats = dict(sched.stats)
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
        thread.join(timeout=30)
    for c in calls:
        req = c.pop("_req")
        context = c.pop("_context")
        if (c["status"] != 200 or not c["finish_reason"] or not c["usage"]
                or c["query_to_first_token_s"] is None
                or not c["prompt_has_top_passage"] or req.error):
            raise AssertionError(f"serve_rag: request failed {c}")
        if context[:200] not in tok.decode(req.prompt_ids):
            raise AssertionError("serve_rag: the prompt lacks its context")
    L = cfg.n_layers
    if (launches["flash_prefill"] < L * stats["prefill_dispatches"]
            or stats["prefill_dispatches"] < 1
            or launches["ragged_paged_attention"] < 1
            or launches["sample_slots"] < 1):
        raise AssertionError(f"serve_rag did not run through the kernels: "
                             f"{launches}, {stats}")
    posts = _rag_server_posts(emb, rer, [
        f"{RAG_QUERIES[i % len(RAG_QUERIES)]} ({i})"
        for i in range(RAG_POSTS)])
    emb.close()
    rer.close()
    pairs = sum(c["hits"] for c in calls)
    rerank_s = sum(c["rerank_ms"] for c in calls) / 1e3
    emit("serve_rag", corpus_files=len(corpus),
         corpus_bytes=sum(len(t.encode()) for _, t in corpus),
         chunks=len(chunks), chunk_size=app.text_splitter.chunk_size,
         chunk_overlap=app.text_splitter.chunk_overlap, split_s=split_s,
         encoder=(f"e5-base ({e5.n_layers} layers, {e5.dim}, {e5.n_heads} "
                  f"heads, F {e5.hidden_dim}), bfloat16, random, "
                  f"torch.Generator seeds 11 / 13"),
         encoder_param_bytes=encoder_bytes,
         ingest_embed_s=ingest_embed_s,
         docs_per_s=len(chunks) / ingest_embed_s, store_add_s=store_add_s,
         store_bytes=store.nbytes, index_type=store.index_type,
         nr_top_k=app.retriever.nr_top_k, top_k=app.retriever.top_k,
         pairs_per_s=pairs / rerank_s,
         embed_ms_per_query=[c["embed_ms"] for c in calls],
         search_ms_per_query=[c["search_ms"] for c in calls],
         rerank_ms_per_call=[c["rerank_ms"] for c in calls],
         query_to_first_token_s=[c["query_to_first_token_s"] for c in calls],
         server_ttft_s=[c["server_ttft_s"] for c in calls],
         llm=(f"llama3-8b, {cfg.n_layers} layers, {cfg.dtype}, random, "
              f"torch.Generator seed 0"), warmup_s=warmup_s, requests=calls,
         dispatches=stats, launches=launches, encoder_server=posts,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         peak_above_start_gb=(torch.cuda.max_memory_allocated() - mem0)
         / 1e9)
    return launches


CHAIN_FOLLOW_UP = "And how are they checked after that?"
CHAIN_CONCURRENT = 8
CHAIN_TIE_ULPS = 2        # a burst stream may part from its replay only here


def _multipart(name: str, data: bytes):
    """(body, headers) of a multipart/form-data upload of ``data`` as the
    field ``file``, named ``name``."""
    import uuid
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"{name}\"\r\nContent-Type: "
            f"text/markdown\r\n\r\n").encode() + data + (
                f"\r\n--{boundary}--\r\n").encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _chain_json(base, method, path, body=None, timeout=600):
    """(status, parsed JSON or text) of one chain-server call."""
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode("utf-8", "replace")


def _chain_generate(base, rid, messages, use_kb=True,
                    max_tokens=RAG_MAX_TOKENS):
    """One greedy ``/generate`` with ``X-Request-Id`` ``rid``: its status,
    the request id it echoed, its frames checked against the chain
    server's SSE contract, its text and the seconds to its first frame."""
    body = json.dumps({"messages": messages, "use_knowledge_base": use_kb,
                       "max_tokens": max_tokens, "temperature": 0.0}).encode()
    req = urllib.request.Request(base + "/generate", data=body, headers={
        "Content-Type": "application/json", "X-Request-Id": rid})
    t0 = time.perf_counter()
    first = None
    lines = []
    with urllib.request.urlopen(req, timeout=600) as resp:
        status, echoed = resp.status, resp.headers.get("X-Request-Id")
        ctype = resp.headers.get("Content-Type", "")
        for raw in resp:
            if first is None and raw.startswith(b"data: "):
                first = time.perf_counter() - t0
            lines.append(raw.decode())
    frames = [f[len("data: "):] for f in "".join(lines).split("\n\n") if f]
    faults = []
    if status != 200 or echoed != rid or not ctype.startswith(
            "text/event-stream"):
        faults.append(f"status {status}, id {echoed!r}, type {ctype!r}")
    if len(frames) < 2 or frames[-1] != "[DONE]":
        faults.append("no [DONE] frame")
    parsed = [json.loads(f) for f in frames[:-1]]
    for i, chunk in enumerate(parsed):
        choice = chunk["choices"][0]
        last = i == len(parsed) - 1
        if (chunk["id"] != rid or choice["index"] != 0
                or choice["message"]["role"] != "assistant"
                or choice["finish_reason"] != ("stop" if last else None)
                or (last and choice["message"]["content"] != "")):
            faults.append(f"frame {i} breaks the contract: {chunk}")
    if faults:
        raise AssertionError(f"serve_chain_server /generate {rid}: {faults}")
    text = "".join(c["choices"][0]["message"]["content"] for c in parsed)
    return text, first


def _slo_tenant_case(base, sched, submitted):
    """``serve_chain_server``'s SLO and usage case: one ``/generate`` with
    ``X-Slo-Class: batch`` and ``X-Tenant-Id`` answers 200 (the port once
    answered 422); its engine requests carry the class and the tenant;
    ``/debug/slo`` counts the class, ``/debug/usage`` bills the tenant,
    and the engine's ``/health`` body (``ModelServer.health``: this
    phase's engine is in-process, behind ``LocalLLM``) shows the tenant's
    tokens in ``usage_by_tenant``; the timeline names both."""
    from generativeaiexamples_tpu_torch.engine.server import ModelServer
    tenant = "smoke-tenant"
    n = len(submitted)
    body = json.dumps({"messages": [{"role": "user",
                                     "content": RAG_QUERIES[0]}],
                       "max_tokens": 16, "temperature": 0.0}).encode()
    req = urllib.request.Request(base + "/generate", data=body, headers={
        "Content-Type": "application/json", "X-Request-Id": "slo-tenant",
        "X-Slo-Class": "batch", "X-Tenant-Id": tenant})
    with urllib.request.urlopen(req, timeout=600) as resp:
        status, raw = resp.status, resp.read()
    reqs = submitted[n:]
    slo = _get_json(base + "/debug/slo")
    usage = _get_json(base + "/debug/usage")
    _, health = ModelServer(sched, "llama3-8b-random").health()
    rec = (_get_json(f"{base}/debug/requests/{reqs[-1].request_id}")
           if reqs else {})
    billed = usage["tenants"].get(tenant, {})
    rolled = health["usage_by_tenant"].get(tenant, {})
    out_tokens = sum(r.completion_tokens for r in reqs)
    got = dict(status=status, engine_requests=len(reqs),
               classes=sorted({r.slo_class for r in reqs}),
               tenants=sorted({r.tenant for r in reqs}),
               batch_lifetime=slo["classes"]["batch"]["lifetime"],
               usage=billed, health_usage=rolled,
               timeline_class=rec.get("slo_class"),
               timeline_tenant=rec.get("tenant"), tokens_out=out_tokens)
    if (status != 200 or not raw.rstrip().endswith(b"data: [DONE]")
            or not reqs or got["classes"] != ["batch"]
            or got["tenants"] != [tenant]
            or got["batch_lifetime"]["total"] < len(reqs)
            or billed.get("requests") != len(reqs)
            or billed.get("tokens_out") != out_tokens
            or rolled.get("tok_out") != out_tokens or out_tokens < 1
            or rec.get("slo_class") != "batch"
            or rec.get("tenant") != tenant):
        raise AssertionError(f"serve_chain_server SLO / tenant: {got}")
    return got


def phase_serve_chain_server(dev, cfg, params, smi, shared):
    """``serve_rag``'s path behind the port's chain server: full llama3-8b
    (bf16, the default engine config) under ``LocalLLM``, full e5-base
    encoders in bf16 with their micro-batchers on, wired in through
    ``set_context`` and served as ``multi_turn_rag`` by ``ChainServer`` on a
    local port; every call goes over HTTP. Returns the launches of the
    chain server's requests; ``shared`` gets the app config, tokenizer,
    encoders and engine core for ``serve_agents`` (the caller closes the
    encoders)."""
    import torch
    from generativeaiexamples_tpu_torch.chains.context import (ChainContext,
                                                               set_context)
    from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
    from generativeaiexamples_tpu_torch.chains.multi_turn_rag import DOCS
    from generativeaiexamples_tpu_torch.core.config import load_config
    from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
    from generativeaiexamples_tpu_torch.encoders import Embedder, Reranker
    from generativeaiexamples_tpu_torch.engine.scheduler import (Request,
                                                                 Scheduler)
    from generativeaiexamples_tpu_torch.models import bert, llama
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    from generativeaiexamples_tpu_torch.server.api import serve_in_thread
    from generativeaiexamples_tpu_torch.server.registry import get_example
    app = load_config(env={})        # the reference's defaults
    gc.collect()
    torch.cuda.empty_cache()
    tok = smoke_tokenizer()["tok"]
    e5 = bert.BertConfig.e5_base()
    emb = Embedder(cfg=e5, device=dev, dtype="bfloat16", micro_window_s=(
        app.embeddings.microbatch_window_ms / 1e3))
    rer = Reranker(cfg=e5, device=dev, dtype="bfloat16", micro_window_s=(
        app.ranking.microbatch_window_ms / 1e3))
    shared.update(app=app, tok=tok, emb=emb, rer=rer)
    emb.embed_documents(["warm up"])     # first calls: cuBLAS handles
    rer.score("warm", ["up"])
    # the smoke's Llama-3-shaped BPE tokenizer: every id of llama3-8b's
    # vocabulary decodes to text, so the random model's answers stream
    core = serving_core(dev, cfg, params, eos_id=tok.eos_id)
    shared["core"] = core
    warmup_s = core.warmup()
    sched = Scheduler(core, tok)
    submitted = []
    submit = sched.submit

    def recording_submit(req):
        submitted.append(req)
        return submit(req)

    sched.submit = recording_submit
    sched.start()
    set_context(ChainContext(config=app, llm=LocalLLM(sched), embedder=emb,
                             reranker=rer))
    example = get_example("multi_turn_rag")
    pools, funnels = [], {}
    retrieve_pool, funnel = example._retrieve_pool, example._funnel

    def recording_pool(collection, qvec, wide):
        out = retrieve_pool(collection, qvec, wide)
        pools.append((collection, out))
        return out

    def recording_funnel(query, passages):
        out = funnel(query, passages)
        funnels[tuple(passages)] = out
        return out

    example._retrieve_pool = recording_pool
    example._funnel = recording_funnel
    _, httpd, thread = serve_in_thread(example)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    corpus = rag_corpus()
    names = [os.path.basename(path) for path, _ in corpus]
    calls, faults = [], []
    try:
        k.reset_launch_counts()
        for key in sched.stats:
            sched.stats[key] = 0
        # the registry is the process's: earlier phases' rerankers count
        # into it too, so this phase reads its own dispatches as a difference
        rerank_counter = REGISTRY.counter("rerank_dispatches")
        rerank0 = rerank_counter.value
        t0 = time.perf_counter()
        for name, (_, text) in zip(names, corpus):
            body, headers = _multipart(name, text.encode())
            status, _, raw = _post(base + "/documents", body, headers)
            if status != 200 or json.loads(raw) != {
                    "message": "File uploaded successfully"}:
                faults.append(f"upload {name}: {status} {raw[:200]}")
        upload_s = time.perf_counter() - t0
        chunks = len(example.ctx.store(DOCS))
        status, listed = _chain_json(base, "GET", "/documents")
        if status != 200 or sorted(listed["documents"]) != sorted(names):
            faults.append(f"GET /documents: {status} {listed}")
        searches = []
        for query in RAG_QUERIES:
            t1 = time.perf_counter()
            status, found = _chain_json(base, "POST", "/search",
                                        {"query": query, "top_k": 4})
            searches.append(time.perf_counter() - t1)
            if (status != 200 or len(found["chunks"]) != 4
                    or any(c["filename"] not in names
                           for c in found["chunks"])):
                faults.append(f"/search {query!r}: {status}")
        status, bad = _chain_json(base, "POST", "/generate",
                                  {"messages": []})
        if status != 422:
            faults.append(f"an empty /generate answered {status}")

        def turn(rid, messages, use_kb=True):
            n_sub, n_pool = len(submitted), len(pools)
            text, first_s = _chain_generate(base, rid, messages, use_kb)
            reqs = submitted[n_sub:]
            docs_pool = [p for c, p in pools[n_pool:] if c == DOCS]
            calls.append(dict(rid=rid, text=text, first_frame_s=first_s,
                              reqs=reqs, docs_pool=(docs_pool[-1]
                                                    if docs_pool else None),
                              use_kb=use_kb))
            return text

        answers = [turn(f"rag-{i}", [{"role": "user", "content": q}])
                   for i, q in enumerate(RAG_QUERIES)]
        turn("follow-up", [{"role": "user", "content": RAG_QUERIES[0]},
                           {"role": "assistant", "content": answers[0]},
                           {"role": "user", "content": CHAIN_FOLLOW_UP}])
        turn("no-kb", [{"role": "user", "content": RAG_QUERIES[1]}],
             use_kb=False)
        # which embed dispatches carried the burst's queries (the others
        # carry the turns written to the conversation store as each ends)
        batcher = emb._batcher
        dispatch = batcher._dispatch
        query_dispatches = []

        def recording_dispatch(texts):
            query_dispatches.append(sum(t.startswith("query: ")
                                        for t in texts))
            return dispatch(texts)

        batcher._dispatch = recording_dispatch
        dispatches = REGISTRY.counter("embed_dispatches")
        d0, n_sub = dispatches.value, len(submitted)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(CHAIN_CONCURRENT) as pool:
            burst = list(pool.map(lambda i: _chain_generate(
                base, f"burst-{i}", [{"role": "user", "content":
                                      RAG_QUERIES[i % len(RAG_QUERIES)]
                                      + f" ({i})"}]),
                range(CHAIN_CONCURRENT)))
        burst_s = time.perf_counter() - t1
        batcher._dispatch = dispatch
        burst_dispatches = dispatches.value - d0
        query_dispatches = [n for n in query_dispatches if n]
        burst_reqs = submitted[n_sub:]
        status, deleted = _chain_json(base, "DELETE",
                                      f"/documents?filename={names[0]}")
        if status != 200 or deleted != {"deleted": True}:
            faults.append(f"DELETE /documents: {status} {deleted}")
        status, listed = _chain_json(base, "GET", "/documents")
        if sorted(listed["documents"]) != sorted(names[1:]):
            faults.append(f"after the delete: {listed}")
        launches = k.launch_counts()
        stats = dict(sched.stats)
        _, metrics = _chain_json(base, "GET", "/metrics")
        rerank_dispatches = rerank_counter.value - rerank0
        slo_tenant = _slo_tenant_case(base, sched, submitted)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        sched.stop()
        set_context(None)
    # each answer against the engine's own greedy stream of its prompt ids,
    # submitted directly to a fresh Scheduler over the same core (an empty
    # prefix cache, as the chain's run began): the sequential requests one
    # at a time in their order, then the burst's together
    replay = Scheduler(core, tok)
    replay.start()
    try:
        def again(req):
            return Request(prompt_ids=list(req.prompt_ids),
                           max_tokens=req.max_tokens, temperature=0.0,
                           top_p=req.top_p, stop=list(req.stop))

        direct = {}
        for req in [r for c in calls for r in c["reqs"]]:
            twin = replay.submit(again(req))
            direct[id(req)] = (twin, "".join(replay.iter_text(twin)))
        twins = [replay.submit(again(req)) for req in burst_reqs]
        for req, twin in zip(burst_reqs, twins):
            direct[id(req)] = (twin, "".join(replay.iter_text(twin)))
    finally:
        replay.stop()
    for c in calls:
        for req in c["reqs"]:
            twin = direct[id(req)][0]
            if req.error or twin.error or req.output_ids != twin.output_ids:
                faults.append(f"{c['rid']}: the chain's engine stream "
                              f"differs from the direct one")
        if len(c["reqs"]) != (2 if c["rid"] == "follow-up" else 1):
            faults.append(f"{c['rid']}: {len(c['reqs'])} engine requests")
            continue
        answer = c["reqs"][-1]
        if direct[id(answer)][1] != c["text"]:
            faults.append(f"{c['rid']}: the SSE text differs from the "
                          f"direct stream")
        if c["use_kb"]:
            top = funnels.get(tuple(c["docs_pool"] or ()), [None])[0]
            if top is None or top[:200] not in tok.decode(answer.prompt_ids):
                faults.append(f"{c['rid']}: the prompt lacks its top "
                              f"reranked passage")
    # the burst's requests reached the engine as the chain sent them, the
    # replay's together: a stream may part from its twin only where the
    # plain forward's top two logits are within CHAIN_TIE_ULPS bf16 ulps
    burst_report = []
    for req in burst_reqs:
        twin = direct[id(req)][0]
        if req.error or twin.error:
            faults.append(f"burst request {req.request_id} failed")
            continue
        a, b = req.output_ids, twin.output_ids
        if a == b:
            burst_report.append({"identical": True, "tokens": len(a)})
            continue
        step = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        ids = torch.tensor([list(req.prompt_ids) + a[:step]], device=dev)
        with torch.no_grad():
            logits = llama.forward(params, cfg, ids)[0, -1].float()
        top2 = logits.topk(2).values
        gap, limit = (top2[0] - top2[1]).item(), (
            CHAIN_TIE_ULPS * BF16_ULP * abs(top2[0].item()))
        burst_report.append({"identical": False, "step": step,
                             "top2_gap": gap, "limit": limit})
        if gap > limit:
            faults.append(f"burst request {req.request_id}: parts from the "
                          f"direct stream at step {step}, top-2 gap {gap}")
    if len(burst) != CHAIN_CONCURRENT or len(burst_reqs) != CHAIN_CONCURRENT:
        faults.append(f"{len(burst_reqs)} engine requests for "
                      f"{CHAIN_CONCURRENT} concurrent ones")
    if (sum(query_dispatches) != CHAIN_CONCURRENT
            or not 1 <= len(query_dispatches) < CHAIN_CONCURRENT):
        faults.append(f"the burst's {CHAIN_CONCURRENT} queries took "
                      f"{len(query_dispatches)} embed dispatches "
                      f"({query_dispatches})")
    L = cfg.n_layers
    if (launches["flash_prefill"] < L * stats["prefill_dispatches"]
            or stats["prefill_dispatches"] < 1
            or launches["ragged_paged_attention"] < 1
            or launches["sample_slots"] < 1):
        faults.append(f"the chain server's requests did not run through the "
                      f"kernels: {launches}, {stats}")
    stages = {name: metrics.get(f"stage_{name}_s")
              for name in ("condense", "retrieve", "rerank", "generate")}
    if any(v is None or not v.get("count") for v in stages.values()):
        faults.append(f"stage histograms missing: {stages}")
    if faults:
        raise AssertionError(f"serve_chain_server: {faults}")
    first = [c["first_frame_s"] for c in calls]
    emit("serve_chain_server", card=smi, example="multi_turn_rag",
         slo_tenant=slo_tenant,
         corpus_files=len(names), chunks=chunks, upload_s=upload_s,
         upload_docs_per_s=chunks / upload_s,
         search_s=searches,
         request_to_first_frame_s={c["rid"]: c["first_frame_s"]
                                   for c in calls},
         first_turn_to_first_frame_s=first[:len(RAG_QUERIES)],
         follow_up_to_first_frame_s=calls[len(RAG_QUERIES)]["first_frame_s"],
         stage_s={name: {key: v[key] for key in ("count", "mean", "p50",
                                                 "p90")}
                  for name, v in stages.items()},
         e2e_ttft_s=metrics.get("e2e_ttft_s"),
         e2e_latency_s=metrics.get("e2e_latency_s"),
         e2e_tpot_s=metrics.get("e2e_tpot_s"),
         concurrent=dict(requests=CHAIN_CONCURRENT,
                         embed_dispatches=burst_dispatches,
                         query_embed_dispatches=query_dispatches,
                         wall_s=burst_s,
                         first_frame_s=sorted(f for _, f in burst)),
         lookahead=dict(reuse=metrics.get("lookahead_reuse"),
                        requery=metrics.get("lookahead_requery")),
         rerank_dispatches=rerank_dispatches,
         engine_requests=len(direct), burst_vs_direct=burst_report,
         tie_limit=f"{CHAIN_TIE_ULPS} bf16 ulps of the top logit",
         warmup_s=warmup_s,
         llm=(f"llama3-8b, {cfg.n_layers} layers, {cfg.dtype}, random, "
              f"torch.Generator seed 0, the smoke's BPE tokenizer"),
         answer_chars=[len(c["text"]) for c in calls],
         encoder=(f"e5-base ({e5.n_layers} layers, {e5.dim}), bfloat16, "
                  f"random, torch.Generator seeds 11 / 13"),
         dispatches=stats, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


# serve_agents' traffic: two of rag_corpus()'s files (its two smallest) a
# chain, text_to_sql's documentation a note on its tables instead (the
# corpus's chunks would not fit its prompt in 2,048 positions); a
# retriever of AGENT_TOP_K (a smoke choice that bounds the graders' calls;
# the CPU tests hold the default 4), one greedy /generate of
# RAG_MAX_TOKENS a chain, the four chains and three agent loops at once
AGENT_FILES = ("docs/migration.md", "docs/rag_pipeline.md")
AGENT_SQL_NOTE = ("tables.md", "The kernels table names each CUDA kernel "
                  "and its source file. The phases table names each smoke "
                  "phase and its seconds. The launches table counts the "
                  "launches of a kernel in a phase.\n")
AGENT_TOP_K = 2
AGENT_CHAINS = {
    "agentic_rag": RAG_QUERIES[0],
    "router_rag": RAG_QUERIES[1],
    "query_decomposition_rag": RAG_QUERIES[2],
    "text_to_sql": "How many launches did each kernel make in each phase?"}
# (name, description, parameters, behind approval): the episode is forced
# to ``report``, so the approval gate opens on every step
AGENT_TOOLS = (
    ("lookup", "Look a topic up in the notes.",
     {"type": "object", "properties": {
         "topic": {"type": "string",
                   "enum": ["kernels", "chains", "serving"]}},
      "required": ["topic"]}, False),
    ("report", "Send a short report to a team.",
     {"type": "object", "properties": {
         "to": {"type": "string", "maxLength": 12},
         "urgent": {"type": "boolean"}},
      "required": ["to", "urgent"]}, True))
AGENT_TOOL_TOKENS = 128
AGENT_EXTRACT = ("flash_prefill launched 288 times in serve_chain_server, "
                 "on the card.")
AGENT_BASH_OK = r"(ls|pwd)( [\w./-]+)*"    # the only commands approved
# the extraction's and the bash agent's replies decode under these (their
# reply formats), so random weights answer in them: every bash turn is a
# command the policy approves, run in the agent's folder (the CPU tests
# hold the declined path)
AGENT_EXTRACT_SCHEMA = {"type": "object", "properties": {
    "kernel": {"type": "string", "maxLength": 24},
    "launches": {"type": "number"},
    "on_card": {"type": "boolean"}}, "required": ["kernel", "launches"]}
AGENT_BASH_SCHEMA = {"type": "object", "properties": {
    "tool": {"enum": ["exec_bash_command"]},
    "cmd": {"enum": ["ls", "ls -t", "pwd"]}},
    "required": ["tool", "cmd"]}


class _Tagged:
    """A Scheduler as one chain's ``LocalLLM`` sees it: the requests it
    submits are recorded, with the text each streamed."""

    def __init__(self, sched):
        self._sched = sched
        self.reqs = []
        self.texts = {}

    def __getattr__(self, name):
        return getattr(self._sched, name)

    def submit(self, req):
        self.reqs.append(req)
        return self._sched.submit(req)

    def iter_text(self, req):
        parts = []
        for piece in self._sched.iter_text(req):
            parts.append(piece)
            yield piece
        self.texts[id(req)] = "".join(parts)


class _ToolChoice:
    """A LocalLLM with every tool turn under ``choice``: ToolAgent sends
    "auto", which attaches no grammar, so random weights call no tool."""

    def __init__(self, llm, choice):
        self.llm, self.choice = llm, choice

    def chat_tools(self, messages, tools, tool_choice="auto", **sampling):
        return self.llm.chat_tools(messages, tools, tool_choice=self.choice,
                                   **sampling)


class _Schema:
    """A LocalLLM whose ``chat`` decodes under the JSON grammar of
    ``schema``, in at most AGENT_TOOL_TOKENS tokens."""

    def __init__(self, llm, schema):
        from generativeaiexamples_tpu_torch.engine.grammar import Grammar
        self.llm, self.grammar = llm, Grammar.from_schema(schema)

    def chat(self, messages, max_tokens=256, **sampling):
        return self.llm.chat(messages, grammar=self.grammar,
                             max_tokens=min(max_tokens, AGENT_TOOL_TOKENS),
                             **sampling)


def _agent_db(path):
    """A sqlite file of three tables (kernels, phases, launches)."""
    import sqlite3
    conn = sqlite3.connect(path)
    conn.executescript(
        "CREATE TABLE kernels (id INTEGER PRIMARY KEY, name TEXT, "
        "source TEXT);"
        "CREATE TABLE phases (id INTEGER PRIMARY KEY, name TEXT, "
        "seconds REAL);"
        "CREATE TABLE launches (kernel_id INTEGER REFERENCES kernels(id), "
        "phase_id INTEGER REFERENCES phases(id), n INTEGER);")
    conn.executemany("INSERT INTO kernels (name, source) VALUES (?, ?)",
                     [("flash_prefill", "flash_prefill.cu"),
                      ("sample_slots", "sample_slots.cu")])
    conn.executemany("INSERT INTO phases (name, seconds) VALUES (?, ?)",
                     [("serve", 30.0), ("serve_chain_server", 40.0)])
    conn.executemany("INSERT INTO launches VALUES (?, ?, ?)",
                     [(1, 1, 64), (1, 2, 288), (2, 1, 259), (2, 2, 299)])
    conn.commit()
    conn.close()


def _tool_fn(name):
    return lambda **args: f"{name} done: {json.dumps(args, sort_keys=True)}"


def phase_serve_agents(smi, app, tok, emb, rer, core):
    """serve_agents: the agentic chains on ``serve_chain_server``'s engine
    core, tokenizer and encoders (no second engine is drawn, loaded or
    warmed), a new Scheduler over the core. ``agentic_rag``,
    ``router_rag``, ``query_decomposition_rag`` and ``text_to_sql`` each
    behind a ChainServer of its own, with ``AGENT_FILES`` uploaded and one
    ``/generate``; a ``ToolAgent`` episode, a ``StructuredExtractor`` call
    and a ``BashAgent`` run beside them, all at once (``AGENT_SQL_NOTE``
    is text_to_sql's upload). The three loops reply under grammars
    (``_ToolChoice``, ``_Schema``), so each takes its tool or record path.
    Raises on any fault; returns the phase's launches."""
    import dataclasses
    import re
    import shutil
    import sqlite3
    import tempfile
    import torch
    from generativeaiexamples_tpu_torch.chains import NO_CONTEXT_MSG
    from generativeaiexamples_tpu_torch.chains.bash_agent import (BashAgent,
                                                                  BashTool)
    from generativeaiexamples_tpu_torch.chains.context import ChainContext
    from generativeaiexamples_tpu_torch.chains.extraction import (
        Field, StructuredExtractor)
    from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
    from generativeaiexamples_tpu_torch.chains.tool_agent import (Tool,
                                                                  ToolAgent)
    from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    from generativeaiexamples_tpu_torch.server.api import (ERROR_MESSAGE,
                                                           serve_in_thread)
    from generativeaiexamples_tpu_torch.server.registry import get_example
    config = dataclasses.replace(app, retriever=dataclasses.replace(
        app.retriever, top_k=AGENT_TOP_K))
    t0 = time.perf_counter()
    core.ensure_token_bytes(tok)
    token_bytes_s = time.perf_counter() - t0
    sched = Scheduler(core, tok)
    sched.start()
    tagged = {name: _Tagged(sched) for name in
              list(AGENT_CHAINS) + ["tool_agent", "extraction", "bash_agent"]}
    files = []
    for path in AGENT_FILES:
        with open(os.path.join(HERE, path), encoding="utf-8") as fh:
            files.append((os.path.basename(path), fh.read()))
    folder = tempfile.mkdtemp(prefix="serve_agents_")
    db = os.path.join(folder, "smoke.db")
    _agent_db(db)
    examples, servers = {}, {}
    try:
        for name in AGENT_CHAINS:
            examples[name] = get_example(
                name, context=ChainContext(
                    config=config, llm=LocalLLM(tagged[name]), embedder=emb,
                    reranker=rer),
                **({"db_path": db} if name == "text_to_sql" else {}))
        t2s = examples["text_to_sql"]
        trained = t2s.auto_train_schema()
        t2s.train(question="How many times did flash_prefill launch?",
                  sql="SELECT SUM(n) FROM launches JOIN kernels ON "
                      "kernels.id = launches.kernel_id WHERE kernels.name = "
                      "'flash_prefill'")
        agentic = examples["agentic_rag"]
        loop = {"attempts": 0, "grades": [], "rewrites": [],
                "generations": []}
        grade_docs, grade, rewrite, generate = (
            agentic._grade_documents, agentic._grade,
            agentic._rewrite_question, agentic._generate)

        def spy_grade_docs(question, docs, **settings):
            loop["attempts"] += 1
            return grade_docs(question, docs, **settings)

        def spy(key, fn):
            def wrapped(*args, **settings):
                out = fn(*args, **settings)
                loop[key].append(out)
                return out
            return wrapped

        agentic._grade_documents = spy_grade_docs
        agentic._grade = spy("grades", grade)
        agentic._rewrite_question = spy("rewrites", rewrite)
        agentic._generate = spy("generations", generate)
        for name, example in examples.items():
            servers[name] = serve_in_thread(example)
        bases = {name: f"http://127.0.0.1:{s[1].server_address[1]}"
                 for name, s in servers.items()}
        sources = sorted(f for f, _ in files)

        def http_chain(name):
            base, faults = bases[name], []
            t1 = time.perf_counter()
            for fname, text in ([AGENT_SQL_NOTE] if name == "text_to_sql"
                                else files):
                body, headers = _multipart(fname, text.encode())
                status, _, raw = _post(base + "/documents", body, headers)
                if status != 200 or json.loads(raw) != {
                        "message": "File uploaded successfully"}:
                    faults.append(f"upload {fname}: {status} {raw[:200]}")
            status, listed = _chain_json(base, "GET", "/documents")
            want = ["sql_docs"] if name == "text_to_sql" else sources
            if status != 200 or not isinstance(listed, dict) or sorted(
                    listed["documents"]) != want:
                faults.append(f"GET /documents: {status} {listed}")
            text, first = _chain_generate(base, f"agents-{name}", [
                {"role": "user", "content": AGENT_CHAINS[name]}])
            out = dict(text=text, first_frame_s=first, faults=faults)
            if name == "agentic_rag":
                status, found = _chain_json(base, "POST", "/search", {
                    "query": AGENT_CHAINS[name], "top_k": AGENT_TOP_K})
                if (status != 200 or not isinstance(found, dict)
                        or len(found["chunks"]) != AGENT_TOP_K
                        or any(c["filename"] not in sources
                               for c in found["chunks"])):
                    faults.append(f"/search: {status} {found}")
            out["wall_s"] = time.perf_counter() - t1
            return out

        def tool_episode():
            t1 = time.perf_counter()
            tools = [Tool(name=n, description=d, parameters=p,
                          fn=_tool_fn(n), requires_approval=gated)
                     for n, d, p, gated in AGENT_TOOLS]
            agent = ToolAgent(
                _ToolChoice(LocalLLM(tagged["tool_agent"]), {
                    "type": "function", "function": {"name": "report"}}),
                tools, max_steps=2, max_tokens=AGENT_TOOL_TOKENS,
                temperature=0.0)
            events = list(agent.run("Look up the kernels, then report them "
                                    "to the serving team."))
            verdicts = []
            while events[-1]["type"] == "approval_request":
                verdicts.append(not verdicts)     # approve once, then deny
                events += list(agent.resume(events[-1]["pending"],
                                            approved=verdicts[-1],
                                            feedback="one report is enough"))
            return dict(events=events, verdicts=verdicts,
                        wall_s=time.perf_counter() - t1)

        def extraction():
            t1 = time.perf_counter()
            fields = [Field("kernel", "string", "the kernel's name"),
                      Field("launches", "number"),
                      Field("on_card", "boolean", required=False)]
            record = StructuredExtractor(
                _Schema(LocalLLM(tagged["extraction"]),
                        AGENT_EXTRACT_SCHEMA),
                max_retries=0).extract(AGENT_EXTRACT, fields)
            return dict(record=record, wall_s=time.perf_counter() - t1)

        def bash():
            t1 = time.perf_counter()
            workdir = os.path.join(folder, "bash")
            os.makedirs(workdir)
            with open(os.path.join(workdir, "notes.txt"), "w") as fh:
                fh.write("serve_agents\n")
            agent = BashAgent(
                _Schema(LocalLLM(tagged["bash_agent"]), AGENT_BASH_SCHEMA),
                tool=BashTool(root_dir=workdir, timeout_s=5.0),
                confirm=lambda cmd: re.fullmatch(AGENT_BASH_OK, cmd)
                is not None, max_turns=2)
            answer, transcript = agent.run("List the files here and say "
                                           "which one is newest.")
            return dict(answer_chars=len(answer), transcript=transcript,
                        wall_s=time.perf_counter() - t1)

        counters = ("lookahead_reuse", "lookahead_requery",
                    "generate_errors")
        before = {n: REGISTRY.counter(n).value for n in counters}
        k.reset_launch_counts()
        core.sample_calls = 0
        for key in sched.stats:
            sched.stats[key] = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(tagged)) as pool:
            futs = {name: pool.submit(http_chain, name)
                    for name in AGENT_CHAINS}
            futs.update(tool_agent=pool.submit(tool_episode),
                        extraction=pool.submit(extraction),
                        bash_agent=pool.submit(bash))
            results = {name: f.result() for name, f in futs.items()}
        traffic_s = time.perf_counter() - t0
        launches = k.launch_counts()
        sample_calls = core.sample_calls
        stats = dict(sched.stats)
        moved = {n: REGISTRY.counter(n).value - before[n] for n in counters}
        try:
            t2s.run_sql("DELETE FROM launches")
            refused = None
        except sqlite3.Error as exc:
            refused = f"{type(exc).__name__}: {exc}"
        rows_left = t2s.run_sql("SELECT COUNT(*) FROM launches")[1]
    finally:
        for _, httpd, thread in servers.values():
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        sched.stop()
        shutil.rmtree(folder, ignore_errors=True)
    faults = [f"{name}: {f}" for name in AGENT_CHAINS
              for f in results[name]["faults"]]
    for name, t in tagged.items():
        if not t.reqs:
            faults.append(f"{name} sent no engine request")
        for req in t.reqs:
            if req.error or not req.output_ids:
                faults.append(f"{name}: request {req.request_id} failed: "
                              f"{req.error}")

    def last_text(name):
        reqs = tagged[name].reqs
        return tagged[name].texts.get(id(reqs[-1])) if reqs else None

    # each answer is the engine's stream of the chain's last call, or the
    # chain's own documented fallback
    allowed = {
        "agentic_rag": [NO_CONTEXT_MSG] + loop["generations"][-1:],
        "router_rag": [last_text("router_rag")],
        "query_decomposition_rag": [NO_CONTEXT_MSG,
                                    "I can't find an answer for that.",
                                    last_text("query_decomposition_rag")],
        "text_to_sql": [last_text("text_to_sql")]}
    for name in AGENT_CHAINS:
        text = results[name]["text"]
        if text == ERROR_MESSAGE or not (
                text in allowed[name] or (
                    name == "text_to_sql" and text.startswith(
                        "I could not answer that with SQL: "))):
            faults.append(f"{name} answered {text[:120]!r}")
    if moved["generate_errors"]:
        faults.append(f"{moved['generate_errors']} chain errors")
    schemas = {n: p for n, _, p, _ in AGENT_TOOLS}
    episode = results["tool_agent"]
    calls = [e["call"]["function"] for e in episode["events"]
             if e["type"] in ("tool_call", "approval_request")]
    invalid = [c for c in calls if c["name"] != "report"
               or not validates(json.loads(c["arguments"]),
                                schemas[c["name"]])]
    executed = [e for e in episode["events"]
                if e["type"] == "tool_call" and e.get("approved")]
    if (not calls or invalid or episode["verdicts"][:1] != [True]
            or len(executed) != 1
            or episode["events"][-1]["type"] != "final"):
        faults.append(f"tool_agent: calls {calls}, invalid {invalid}, "
                      f"verdicts {episode['verdicts']}")
    attached = {name: [r.grammar_attached for r in tagged[name].reqs]
                for name in ("tool_agent", "extraction", "bash_agent")}
    if not all(flags and all(flags) for flags in attached.values()):
        faults.append(f"grammar_attached {attached}")
    # every bash turn is a command (its grammar) that the policy approved
    # and that ran in the agent's folder
    transcript = results["bash_agent"]["transcript"]
    if len(transcript) != 2:
        faults.append(f"bash_agent: {len(transcript)} steps, not 2")
    for step in transcript:
        if (re.fullmatch(AGENT_BASH_OK, step["cmd"]) is None
                or step.get("returncode") != "0"
                or ("notes.txt" not in step["stdout"] if step["cmd"] != "pwd"
                    else not step["stdout"].strip().endswith("bash"))):
            faults.append(f"bash_agent step {step}")
    if refused is None or rows_left != [(4,)]:
        faults.append(f"text_to_sql's authorizer let a write through: "
                      f"{rows_left}")
    for name in ("flash_prefill", "ragged_paged_attention", "sample_slots",
                 "grammar_mask"):
        if launches[name] < 1:
            faults.append(f"{name} never launched")
    if launches["sample_slots"] != sample_calls:
        faults.append(f"{launches['sample_slots']} sample_slots launches "
                      f"for {sample_calls} sampling calls")
    if faults:
        raise AssertionError("serve_agents: " + "; ".join(faults))
    per_chain = {}
    for name, t in tagged.items():
        per_chain[name] = dict(
            engine_requests=len(t.reqs),
            tokens=sum(len(r.output_ids) for r in t.reqs),
            wall_s=results[name]["wall_s"])
        if name in AGENT_CHAINS:
            per_chain[name].update(first_frame_s=results[name][
                "first_frame_s"], answer_chars=len(results[name]["text"]))
    emit("serve_agents", card=smi, traffic_s=traffic_s,
         token_byte_table_s=token_bytes_s, chains=per_chain,
         agentic=dict(attempts=loop["attempts"], grades=loop["grades"],
                      rewrites=len(loop["rewrites"]),
                      generations=len(loop["generations"])),
         lookahead=dict(reuse=moved["lookahead_reuse"],
                        requery=moved["lookahead_requery"]),
         grammar_attached=attached,
         tool_events=[e["type"] for e in episode["events"]],
         tool_calls=calls, verdicts=episode["verdicts"],
         extraction={key: v for key, v in results["extraction"].items()
                     if key != "wall_s"},
         bash_transcript=results["bash_agent"]["transcript"],
         sql=dict(tables_trained=trained, write_refused=refused),
         top_k=AGENT_TOP_K, dispatches=stats, launches=launches,
         sample_calls=sample_calls,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


# serve_events' traffic: six advisories through the CVE triage handler at
# once (EVENT_CONCURRENCY), the handler's LLM under the verdict schema's
# grammar (random weights then answer a verdict that parses) in at most
# EVENT_TOKENS tokens, over an inventory of EVENT_INVENTORY in a
# collection of its own; one poisoned event whose handler always raises,
# retried EVENT_RETRIES times on a backoff of base EVENT_RETRY_S, then
# dead-lettered
EVENT_SCHEMA = {"type": "object", "properties": {
    "cve": {"type": "string", "maxLength": 16},
    "affected": {"type": "boolean"},
    "severity": {"enum": ["low", "medium", "high", "critical"]},
    "justification": {"type": "string", "maxLength": 24}},
    "required": ["cve", "affected", "severity", "justification"]}
EVENT_ADVISORIES = (
    ("CVE-2026-0001", "remote code execution in pump firmware 2.x"),
    ("CVE-2026-0002", "denial of service in the valve web ui"),
    ("CVE-2026-0003", "authentication bypass in the site gateway"),
    ("CVE-2026-0004", "stored xss in the operator dashboard"),
    ("CVE-2026-0005", "heap overflow in the telemetry parser"),
    ("CVE-2026-0006", "credential leak in the audit logger"))
EVENT_INVENTORY = (
    "Every site runs pump firmware 2.1 behind the site gateway 4.0.",
    "The valve web ui and the operator dashboard are reachable only from "
    "the plant network.",
    "Telemetry is parsed by the collector 1.8; the audit logger is off.")
EVENT_POISON = "CVE-2026-9999"
EVENT_TOKENS = 64
EVENT_CONCURRENCY = 4
EVENT_RETRIES = 2
EVENT_RETRY_S = 0.05
# the data chains' turn on the card: each reply at most this many tokens
DATA_CHAIN_TOKENS = 16
DATA_CHAIN_CSV = ("machine,site,age_months\npump-1,north,7\n"
                  "pump-2,south,14\nvalve-1,north,3\n")


class _Capped:
    """A LocalLLM whose replies stop at ``cap`` tokens."""

    def __init__(self, llm, cap):
        self.llm, self.cap = llm, cap

    def chat(self, messages, max_tokens=256, **sampling):
        return self.llm.chat(messages, max_tokens=min(max_tokens, self.cap),
                             **sampling)


def _data_chains_turn(app, tok, emb, rer, sched):
    """One turn of ``structured_data_rag`` and of ``knowledge_graph_rag``
    behind the chain server on ``sched`` (each reply capped at
    DATA_CHAIN_TOKENS): an upload, the listing, one ``/generate``. Runs
    only where pandas and networkx are installed; returns a line for
    each chain, or ``{"data_chains": "cpu_only", "missing": [...]}``."""
    import importlib.util
    import shutil
    import tempfile
    missing = [m for m in ("pandas", "networkx")
               if importlib.util.find_spec(m) is None]
    if missing:
        return {"data_chains": "cpu_only", "missing": missing}
    from generativeaiexamples_tpu_torch.chains.context import ChainContext
    from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
    from generativeaiexamples_tpu_torch.server.api import (ERROR_MESSAGE,
                                                           serve_in_thread)
    from generativeaiexamples_tpu_torch.server.registry import get_example
    folder = tempfile.mkdtemp(prefix="serve_events_data_")
    out = {}
    try:
        for name, upload in (
                ("structured_data_rag", ("machines.csv", DATA_CHAIN_CSV)),
                ("knowledge_graph_rag", ("inventory.md",
                                         " ".join(EVENT_INVENTORY)))):
            ctx = ChainContext(config=app, llm=_Capped(LocalLLM(sched),
                                                       DATA_CHAIN_TOKENS),
                               embedder=emb, reranker=rer)
            kw = ({"state_dir": os.path.join(folder, name)}
                  if name == "structured_data_rag" else {})
            example = get_example(name, context=ctx, **kw)
            _, httpd, thread = serve_in_thread(example)
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            t0 = time.perf_counter()
            try:
                body, headers = _multipart(upload[0], upload[1].encode())
                status, _, raw = _post(base + "/documents", body, headers)
                listed = _chain_json(base, "GET", "/documents")
                text, first = _chain_generate(
                    base, f"events-{name}", [
                        {"role": "user", "content": "Which pump is oldest, "
                         "and where does it run?"}],
                    max_tokens=DATA_CHAIN_TOKENS)
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=30)
            if status != 200 or listed != (200, {"documents": [
                    upload[0]]}) or text == ERROR_MESSAGE:
                raise AssertionError(f"serve_events {name}: upload {status} "
                                     f"{raw[:200]}, listed {listed}, "
                                     f"answer {text[:120]!r}")
            out[name] = dict(wall_s=time.perf_counter() - t0,
                             first_frame_s=first, answer_chars=len(text))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return {"data_chains": "card", **out}


def phase_serve_events(smi, app, tok, emb, rer, core):
    """serve_events: the event agent on ``serve_chain_server``'s engine
    core, tokenizer and encoders (nothing new is drawn, loaded or warmed),
    a new Scheduler over the core. ``EVENT_ADVISORIES`` and one poisoned
    event through ``EventDrivenAgent(make_cve_triage_handler(...))`` at
    ``EVENT_CONCURRENCY``: each advisory retrieves from an inventory
    collection and the handler's LLM answers under the verdict schema's
    grammar (``_Schema``), so every verdict parses and validates; the
    poisoned event's handler raises, is retried EVENT_RETRIES times and
    lands in the dead letter and the process's ring. Then the data chains
    on the same engine where pandas and networkx are installed (else one
    ``cpu_only`` line). Raises on any fault; returns the launches of the
    events' run."""
    import torch
    from generativeaiexamples_tpu_torch.chains import event_agent
    from generativeaiexamples_tpu_torch.chains.context import ChainContext
    from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    from generativeaiexamples_tpu_torch.retrieval.store import Document
    sched = Scheduler(core, tok)
    tagged = _Tagged(sched)
    sched.start()
    try:
        ctx = ChainContext(config=app, llm=_Schema(LocalLLM(tagged),
                                                   EVENT_SCHEMA),
                           embedder=emb, reranker=rer)
        ctx.store("inventory").add(
            [Document(content=t, metadata={"source": "inventory.md"})
             for t in EVENT_INVENTORY],
            emb.embed_documents(list(EVENT_INVENTORY)))
        triage = event_agent.make_cve_triage_handler(
            ctx, collection="inventory", top_k=2, max_tokens=EVENT_TOKENS,
            temperature=0.0)
        poison_calls = []

        def handler(event):
            if event.key == EVENT_POISON:
                poison_calls.append(time.perf_counter())
                raise ValueError(f"no JSON verdict in analysis for "
                                 f"{event.key}")
            return triage(event)

        sink = []
        agent = event_agent.EventDrivenAgent(
            handler, result_sink=sink.append,
            max_concurrency=EVENT_CONCURRENCY, max_retries=EVENT_RETRIES,
            retry_delay_s=EVENT_RETRY_S)
        events = [event_agent.Event(key=key, payload={"id": key,
                                                      "summary": summary})
                  for key, summary in EVENT_ADVISORIES]
        events.append(event_agent.Event(key=EVENT_POISON, payload={
            "id": EVENT_POISON, "summary": "a malformed advisory"}))
        ring0 = event_agent.dead_letter_payload()["total"]
        k.reset_launch_counts()
        core.sample_calls = 0
        for key in sched.stats:
            sched.stats[key] = 0
        t0 = time.perf_counter()
        counts = agent.run_sync(event_agent.list_source(events))
        events_s = time.perf_counter() - t0
        launches = k.launch_counts()
        sample_calls = core.sample_calls
        stats = dict(sched.stats)
        ring = event_agent.dead_letter_payload()
        data = _data_chains_turn(app, tok, emb, rer, sched)
    finally:
        sched.stop()
    faults = []
    want = {"processed": len(events), "succeeded": len(EVENT_ADVISORIES),
            "failed": 1, "dead_letter": 1}
    if counts != want:
        faults.append(f"counts {counts}, not {want}")
    by_key = {r.key: r for r in agent.results}
    verdicts = {}
    for key, _ in EVENT_ADVISORIES:
        r = by_key.get(key)
        try:
            verdicts[key] = json.loads(r.output)
        except (AttributeError, TypeError, ValueError):
            faults.append(f"{key}: no verdict ({r})")
            continue
        if not r.ok or r.attempts != 1 or not validates(verdicts[key],
                                                        EVENT_SCHEMA):
            faults.append(f"{key}: {r}")
    poison = by_key.get(EVENT_POISON)
    if (poison is None or poison.ok or poison.attempts != EVENT_RETRIES + 1
            or len(poison_calls) != EVENT_RETRIES + 1
            or [e.key for e in agent.dead_letter] != [EVENT_POISON]):
        faults.append(f"the poisoned event: {poison}, "
                      f"{len(poison_calls)} calls, dead letter "
                      f"{agent.dead_letter}")
    if ring["total"] != ring0 + 1 or ring["dead_letters"][0]["key"] != \
            EVENT_POISON:
        faults.append(f"the dead-letter ring {ring}")
    if len(sink) != len(events):
        faults.append(f"the sink took {len(sink)} results")
    if len(tagged.reqs) != len(EVENT_ADVISORIES) or not all(
            r.grammar_attached and not r.error for r in tagged.reqs):
        states = [(r.grammar_attached, r.error) for r in tagged.reqs]
        faults.append(f"engine requests {states}")
    for name in ("flash_prefill", "ragged_paged_attention", "sample_slots",
                 "grammar_mask"):
        if launches[name] < 1:
            faults.append(f"{name} never launched")
    if launches["sample_slots"] != sample_calls:
        faults.append(f"{launches['sample_slots']} sample_slots launches "
                      f"for {sample_calls} sampling calls")
    if faults:
        raise AssertionError("serve_events: " + "; ".join(faults))
    backoffs = [b - a for a, b in zip(poison_calls, poison_calls[1:])]
    emit("serve_events", card=smi, events_s=events_s, **counts,
         engine_requests=len(tagged.reqs),
         tokens=sum(len(r.output_ids) for r in tagged.reqs),
         latency_s={r.key: r.latency_s for r in agent.results},
         poison_retry_gaps_s=backoffs, verdicts=verdicts,
         dispatches=stats, launches=launches,
         grammar_mask_launches=launches["grammar_mask"],
         sample_calls=sample_calls,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps(data), flush=True)
    return launches


# serve_qos (the QoS admission plane and the forensics plane on
# serve_chain_server's engine core): tenants gold and bulk weighted 4:1,
# bulk's QOS_BULK chats first (admitted together: 8 slots, so 4 wait),
# then gold's QOS_GOLD while bulk's first wave decodes, and one
# best_effort chat (the sheddable class: batch is not, in the reference's
# classes) with a 1 ms deadline; every chat greedy, QOS_TOKENS tokens, its
# templated prompt QOS_PAGE_TAIL tokens short of a page boundary at most,
# so decode grows into a new page while both tenants hold slots
QOS_WEIGHTS = "gold=4,bulk=1,*=1"
QOS_BULK, QOS_GOLD, QOS_TOKENS = 12, 4, 32
QOS_PAGE_TAIL = (8, 24)
QOS_DOOMED = "qos-doomed"


def _qos_prompts(tok, page_size):
    """(tenant, request id, chat text) of serve_qos's chats, bulk's first:
    ``PROMPT_TEXT``'s words after the request's name, as many as leave the
    templated prompt between ``QOS_PAGE_TAIL`` tokens short of a page."""
    words = PROMPT_TEXT.split()
    out = []
    for tenant, n in (("bulk", QOS_BULK), ("gold", QOS_GOLD)):
        for i in range(n):
            text, j = f"{tenant} request {i}:", i
            while True:
                ids = tok.apply_chat_template([{"role": "user",
                                                "content": text}])
                short = -len(ids) % page_size
                if len(ids) > page_size // 2 and \
                        QOS_PAGE_TAIL[0] <= short <= QOS_PAGE_TAIL[1]:
                    break
                text += " " + words[j % len(words)]
                j += 1
            out.append((tenant, f"qos-{tenant}-{i}", text))
    return out


def _qos_chat(base, text, rid, headers):
    """One greedy, unstreamed chat: (status, body)."""
    body = json.dumps({"messages": [{"role": "user", "content": text}],
                       "max_tokens": QOS_TOKENS,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json", "X-Request-Id": rid,
                 **headers})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _top2_gap(dev, cfg, params, prompt, a, b):
    """Where greedy streams a and b of ``prompt`` part: (step, the plain
    forward's top-2 logit gap there, the CHAIN_TIE_ULPS limit); None when
    they are equal."""
    import torch
    from generativeaiexamples_tpu_torch.models import llama
    if a == b:
        return None
    step = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))
    ids = torch.tensor([list(prompt) + list(a[:step])], device=dev)
    with torch.no_grad():
        logits = llama.forward(params, cfg, ids)[0, -1].float()
    top2 = logits.topk(2).values
    return (step, (top2[0] - top2[1]).item(),
            CHAIN_TIE_ULPS * BF16_ULP * abs(top2[0].item()))


def phase_serve_qos(dev, cfg, params, smi, tok, core, **_):
    """serve_qos: the QoS admission plane (``APP_QOS=fair``,
    ``QOS_WEIGHTS``) and the forensics plane (``APP_FORENSICS=on``, the
    trace on) over the port's engine server, on ``serve_chain_server``'s
    engine core and tokenizer (llama3-8b, bf16, 8 slots, warm; nothing new
    is drawn or built) with a new Scheduler, after every earlier
    scheduler over the core stopped. Traffic: ``_qos_prompts`` over HTTP
    with ``X-Tenant-Id`` (bulk's admitted together, gold's once bulk's
    first wave decodes) and ``QOS_DOOMED`` (best_effort, ``X-Deadline-Ms:
    1``). Once both tenants hold slots, the chaos plane's ``page.exhaust``
    fails every page allocation until the scheduler preempts one job.
    Checks: the doomed chat is shed before prefill (503 naming the shed,
    ``slo_outcome`` "shed", its trace a ``qos`` shed and no dispatch);
    gold's chats are admitted before bulk's backlog drains, as
    ``/debug/qos``'s virtual times at gold's arrival predict; the victim is
    a bulk job; every stream equals its replay with ``APP_QOS`` off on the
    same core, from an empty prefix cache, in the live admission order, or
    parts from it only at a top-2 tie within ``CHAIN_TIE_ULPS`` bf16 ulps;
    ``/debug/qos``, ``/debug/alerts``, ``/debug/forensics[/<rid>]`` and
    ``/debug/doctor`` answer with the reference's keys (the doctor naming
    the shed and the page pressure), ``/health`` carries
    ``alerts_active``, a flight dump holds ``qos``; ``flash_prefill``,
    ``ragged_paged_attention`` and ``sample_slots`` launched. Raises on
    any fault; returns the launches of the phase's window."""
    import tempfile
    import torch
    from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
    from generativeaiexamples_tpu_torch.engine import qos as qos_mod
    from generativeaiexamples_tpu_torch.engine.scheduler import (Request,
                                                                 Scheduler)
    from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
    from generativeaiexamples_tpu_torch.observability import (alerts,
                                                              forensics, slo)
    from generativeaiexamples_tpu_torch.observability.chaos import CHAOS
    from generativeaiexamples_tpu_torch.observability.flight import FLIGHT
    from generativeaiexamples_tpu_torch.observability.trace import TRACE
    from generativeaiexamples_tpu_torch.ops.cuda import attention as k
    prompts = _qos_prompts(tok, core.page_size)
    env = {"APP_QOS": "fair", "APP_QOS_TENANT_WEIGHTS": QOS_WEIGHTS,
           "APP_FORENSICS": "on"}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    TRACE.configure(mode="on")
    TRACE.reset()
    # this phase's verdicts alone set the SLO pressure (a critical one
    # would shed the doomed chat before the QoS plane sees it)
    slo.SLO.reset()
    forensics.FORENSICS.configure(mode="on")
    forensics.FORENSICS.reset()
    alerts.ALERTS.reset()
    shed0 = REGISTRY.counter("qos_shed_before_prefill_total",
                             labels={"tenant": "bulk"}).value
    faults, victims, arm = [], [], {"armed": False, "done": False}
    try:
        sched = Scheduler(core, tok)
        if sched._qos is None:
            raise AssertionError("serve_qos: APP_QOS=fair built no policy")
        submitted = []
        submit = sched.submit

        def recording_submit(req):
            submitted.append(req)
            return submit(req)

        sched.submit = recording_submit
        grow, preempt = sched._grow_pages, sched._preempt

        def grow_then_arm(steps, spec_w=1):
            # on the driver thread: the first growth pass with both tenants
            # in slots and nothing pending arms the forced exhaustion (while
            # bulk still had a backlog the global virtual clock would sit at
            # bulk's, and bulk would overuse nothing)
            if not arm["armed"] and not sched._pending and {
                    "gold", "bulk"} <= {j.request.tenant
                                        for j in sched._slots.values()}:
                CHAOS.configure(mode="on", seed=0,
                                spec="page.exhaust=1/0/100000")
                arm["armed"] = True
            return grow(steps, spec_w)

        def preempt_once(job):
            if arm["armed"] and not arm["done"]:
                CHAOS.configure(mode="off")
                arm["done"] = True
            victims.append((job.request.request_id, job.request.tenant))
            return preempt(job)

        sched._grow_pages, sched._preempt = grow_then_arm, preempt_once
        gate = _gate_admission(sched)
        gate.clear()
        httpd, thread = serve_in_thread(sched, "llama3-8b-random")
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        k.reset_launch_counts()
        core.sample_calls = 0
        for key in sched.stats:
            sched.stats[key] = 0
        t0 = time.perf_counter()
        try:
            with concurrent.futures.ThreadPoolExecutor(
                    len(prompts) + 1) as pool:
                futs = {rid: pool.submit(_qos_chat, base, text, rid,
                                         {"X-Tenant-Id": tenant})
                        for tenant, rid, text in prompts[:QOS_BULK]}
                _wait_for(lambda: len(submitted) >= QOS_BULK,
                          "bulk's chats did not arrive")
                gate.set()
                _wait_for(lambda: sched.stats["decode_dispatches"] >= 1,
                          "bulk's first wave did not decode")
                for tenant, rid, text in prompts[QOS_BULK:]:
                    futs[rid] = pool.submit(_qos_chat, base, text, rid,
                                            {"X-Tenant-Id": tenant})
                futs[QOS_DOOMED] = pool.submit(
                    _qos_chat, base, prompts[0][2], QOS_DOOMED,
                    {"X-Tenant-Id": "bulk", "X-Slo-Class": "best_effort",
                     "X-Deadline-Ms": "1"})
                _wait_for(lambda: len(submitted) >= len(prompts) + 1,
                          "gold's chats did not arrive")
                at_gold = _get_json(base + "/debug/qos")
                rates = sched._qos._charge_rates()
                answers = {rid: f.result() for rid, f in futs.items()}
            traffic_s = time.perf_counter() - t0
            launches = k.launch_counts()
            stats = dict(sched.stats)
            bodies = {path: _get_json(base + path) for path in (
                "/debug/qos", "/debug/alerts", "/debug/forensics",
                f"/debug/forensics/{QOS_DOOMED}", "/debug/doctor",
                "/health", f"/debug/trace?rid={QOS_DOOMED}")}
            if victims:
                bodies["victim"] = _get_json(
                    f"{base}/debug/forensics/{victims[0][0]}")
            with tempfile.TemporaryDirectory() as tmp:
                with open(FLIGHT.dump(os.path.join(tmp, "flight.json"))) as fh:
                    dump = json.load(fh)
            records = TRACE.records()
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            sched.stop()
            CHAOS.reset()
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        # the planes back off: the shed's goodput alert and its SLO hazard
        # are this phase's, not the next phases'
        forensics.FORENSICS.configure(mode="off")
        forensics.FORENSICS.reset()
        alerts.ALERTS.reset()
        slo.SLO.reset()
        TRACE.configure(mode="off")
    reqs = {r.request_id: r for r in submitted}
    admits = [r["rid"] for r in records
              if r["kind"] == "admit" and not r.get("resume")]
    # shed before prefill
    doomed = reqs.get(QOS_DOOMED)
    status, body = answers[QOS_DOOMED]
    sheds = [r for r in records if r["kind"] == "qos"
             and r.get("decision") == "shed"]
    shed_dispatch = [r for r in records if r["kind"] == "dispatch"
                     and QOS_DOOMED in str(r.get("rids", "")).split(",")]
    if (doomed is None or doomed.slo_outcome != "shed" or status != 503
            or "shed: deadline unmeetable before prefill"
            not in body.get("error", "") or QOS_DOOMED in admits
            or [r["rid"] for r in sheds] != [QOS_DOOMED] or shed_dispatch
            or REGISTRY.counter("qos_shed_before_prefill_total",
                                labels={"tenant": "bulk"}).value
            != shed0 + 1):
        faults.append(f"the doomed chat was not shed before prefill: "
                      f"{status} {body}, {sheds}, {shed_dispatch}")
    # fair share: at gold's arrival its virtual clock floors at the global
    # one, which bulk's is not behind; each gold admission advances it by a
    # quarter of its cost, so gold's chats go before bulk's backlog drains.
    # The predicted order: a policy of the same weights and rates started
    # from that snapshot, merging the chats that waited then
    vt = {t: row["virtual_time"] for t, row in at_gold["tenants"].items()}
    floor = at_gold["global_virtual_time"]
    wave = [rid for rid in admits[len(admits) - QOS_GOLD - (
        QOS_BULK - 8):]]
    model = qos_mod.QosPolicy(weights={"gold": 4.0, "bulk": 1.0})
    if rates is not None:
        model.configure_estimate(*rates)
    model._vtime, model._global_v = dict(vt), floor
    predicted = [j.request.request_id for j in model.order(
        [type("Job", (), {"request": reqs[rid], "gen_ids": [],
                          "spill": None})() for rid in sorted(
            wave, key=lambda rid: reqs[rid].submitted_at)], len(wave))]
    gold_at = [admits.index(rid) for _, rid, _ in prompts[QOS_BULK:]
               if rid in admits]
    last_bulk = max(i for i, rid in enumerate(admits)
                    if rid.startswith("qos-bulk"))
    if (len(gold_at) != QOS_GOLD or not vt.get("bulk")
            or max(vt.get("gold", floor), floor) > vt["bulk"]
            or max(gold_at) > last_bulk
            or max(predicted.index(rid) for rid in predicted
                   if rid.startswith("qos-gold")) > max(
                predicted.index(rid) for rid in predicted
                if rid.startswith("qos-bulk"))
            or len(admits) != len(prompts)):
        faults.append(f"gold did not go before bulk's backlog: admits "
                      f"{admits}, predicted {predicted}, virtual times at "
                      f"gold's arrival {vt} (global {floor})")
    # the preemption
    if not arm["done"] or not victims or victims[0][1] != "bulk":
        faults.append(f"the forced exhaustion's victim {victims} (armed "
                      f"{arm})")
    # every stream against its replay with the plane off, admitted in the
    # live order from an empty prefix cache
    live = [reqs[rid] for rid in admits]
    for rid, (code, answer) in answers.items():
        if rid != QOS_DOOMED and (code != 200 or reqs[rid].error):
            faults.append(f"{rid}: {code} {answer}")
    replay = Scheduler(core, tok)
    gate = _gate_admission(replay)
    gate.clear()
    replay.start()
    try:
        twins = [replay.submit(Request(prompt_ids=list(r.prompt_ids),
                                       max_tokens=r.max_tokens,
                                       temperature=0.0)) for r in live]
        gate.set()
        for twin in twins:
            "".join(replay.iter_text(twin))
    finally:
        replay.stop()
    if replay._qos is not None:
        faults.append("the replay's scheduler held a QoS policy")
    parted = {}
    for req, twin in zip(live, twins):
        gap = _top2_gap(dev, cfg, params, req.prompt_ids, req.output_ids,
                        twin.output_ids)
        if twin.error or gap is not None:
            parted[req.request_id] = gap
            if twin.error or gap[1] > gap[2]:
                faults.append(f"{req.request_id} parts from its replay at "
                              f"{gap} ({twin.error})")
    # the debug surfaces
    keys = {"/debug/qos": ("enabled", "mode", "default_weight",
                           "global_virtual_time", "outstanding_admissions",
                           "max_tenants", "tenants", "estimate"),
            "/debug/alerts": ("active", "fired_total", "recent_fired",
                              "objectives", "rules", "enabled"),
            "/debug/forensics": ("enabled", "mode", "capacity", "captured",
                                 "p99_samples", "trailing_p99_s",
                                 "exemplars"),
            "/debug/doctor": ("healthy", "diagnoses", "alerts",
                              "slo_pressure", "forensics", "qos",
                              "generated_unix")}
    for path, want in keys.items():
        if sorted(bodies[path]) != sorted(want):
            faults.append(f"{path} keys {sorted(bodies[path])}")
    exemplar = bodies[f"/debug/forensics/{QOS_DOOMED}"]
    if (not exemplar.get("captured") or exemplar.get("reason") != "shed"
            or "shed" not in [s["label"] for s in
                              exemplar["breakdown"]["segments"]]):
        faults.append(f"the doomed chat's exemplar {exemplar}")
    causes = {d["cause"] for d in bodies["/debug/doctor"]["diagnoses"]}
    if not {"qos_shed", "page_pressure"} <= causes:
        faults.append(f"the doctor names {causes}")
    if "alerts_active" not in bodies["/health"]:
        faults.append("/health lacks alerts_active")
    if not dump.get("qos", {}).get("enabled"):
        faults.append(f"the flight dump's qos: {dump.get('qos')}")
    qos_body = bodies["/debug/qos"]
    if (not qos_body["enabled"] or qos_body["outstanding_admissions"] != 0
            or qos_body["tenants"]["bulk"]["virtual_time"]
            <= qos_body["tenants"]["gold"]["virtual_time"]):
        faults.append(f"/debug/qos after the traffic: {qos_body}")
    for name in ("flash_prefill", "ragged_paged_attention", "sample_slots"):
        if launches[name] < 1:
            faults.append(f"{name} never launched")
    if faults:
        raise AssertionError("serve_qos: " + "; ".join(faults))
    victim_bd = bodies.get("victim", {}).get("breakdown", {})
    emit("serve_qos", card=smi, traffic_s=traffic_s,
         weights=QOS_WEIGHTS, admission_order=admits,
         virtual_times_at_gold_arrival=vt, global_at_gold_arrival=floor,
         second_wave=dict(admitted=wave, predicted=predicted,
                          equal=wave == predicted),
         virtual_times_after={t: row["virtual_time"] for t, row in
                              qos_body["tenants"].items()},
         global_virtual_time=qos_body["global_virtual_time"],
         estimate=qos_body["estimate"],
         shed=dict(status=status, error=body.get("error"),
                   est_s=sheds[0].get("est_s"),
                   basis=at_gold["estimate"]["basis"]),
         victims=victims,
         victim_segments=[(s["label"], s["cause"]) for s in
                          victim_bd.get("segments", [])],
         replay_parted=parted, tie_limit=f"{CHAIN_TIE_ULPS} bf16 ulps",
         doctor=sorted(causes),
         exemplars=[(e["rid"], e["reason"]) for e in
                    bodies["/debug/forensics"]["exemplars"]],
         alerts_active=bodies["/health"]["alerts_active"],
         tokens=sum(len(r.output_ids) for r in live),
         dispatches=stats, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_retrieval_ivf(dev):
    """The port's ``retrieval/bench_ivf`` at its defaults (1,000,000 x 384
    clustered rows, nlist 1,024, nprobe 32, 32 queries) on the card: exact
    and IVF ms a query, recall@10 of IVF against exact, build and ingest
    seconds, each store's device bytes and the phase's peak."""
    import torch
    from generativeaiexamples_tpu_torch.retrieval import bench_ivf
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    out = bench_ivf.run(device=dev)
    torch.cuda.synchronize()
    out["peak_above_start_gb"] = (torch.cuda.max_memory_allocated()
                                  - mem0) / 1e9
    # IVF must probe fewer rows than the corpus and find most of the exact
    # top-10 (a recall under 0.5 is a broken index, not a tuning matter)
    if (out["device"] != str(dev) or out["rows_scanned_ivf"] >= out["n"]
            or out["recall_at_10_vs_exact"] < 0.5):
        raise AssertionError(f"retrieval_ivf: {out}")
    emit("retrieval_ivf", **out)
    gc.collect()
    torch.cuda.empty_cache()
    return out


PLANTED_FAULTS = (
    ("flash_dropped_tile", "flash_prefill.cu",
     "    const __nv_bfloat16* vs = ks + BK * LD;\n",
     "    const __nv_bfloat16* vs = ks + BK * LD;\n"
     "    if (kt == 1) continue;\n",
     ("flash_prefill",)),
    ("flash_causal_off_by_one", "flash_prefill.cu",
     "key <= pos", "key < pos", ("flash_prefill",)),
    ("dropped_tile", "common.cuh",
     "    const int t0 = tile * ST;\n",
     "    const int t0 = tile * ST;\n    if (tile == 30) continue;\n",
     ("ragged_paged_attention", "ragged_paged_attention_int8",
      "ragged_decode")),
    ("dropped_split", "common.cuh",
     "const int n_split = S;",
     "const int n_split = S - 1;",
     ("ragged_paged_attention", "ragged_paged_attention_int8",
      "ragged_decode")),
    ("ragged_causal_off_by_one", "common.cuh",
     "lim[h] = qi < n_q ? min(pos0 + qi, len - 1) : -1;",
     "lim[h] = qi < n_q ? min(pos0 + qi - 1, len - 1) : -1;",
     ("ragged_paged_attention", "ragged_paged_attention_int8",
      "ragged_decode")),
    ("wrong_scale_slot", "ragged_paged.cu",
     "sc = (row * KV + kvh) * ps + pos % ps;",
     "sc = (row * KV + kvh) * ps + (pos + 1) % ps;",
     ("ragged_paged_attention_int8",)),
    ("sampler_wrong_rotation", "sample_slots.cu",
     "{13, 15, 26, 6,", "{13, 15, 25, 6,", ("sample_slots",)),
    ("sampler_counter_off_by_one", "sample_slots.cu",
     "threefry2x32(key.x, key.y, 0u, (uint32_t)i)",
     "threefry2x32(key.x, key.y, 0u, (uint32_t)i + 1u)", ("sample_slots",)),
    ("sampler_top_p_strict", "sample_slots.cu",
     "return mass >= target;", "return mass > target;",
     ("sample_slots",)),
    ("gemm_dropped_scale", "w8a16_gemm.cu",
     "  const float sv = __bfloat162float(__float2bfloat16(s));\n",
     "  const float sv = 1.f;\n", ("w8a16_gemm",)),
    ("gemm_skipped_k_tile", "w8a16_gemm.cu",
     "    for (int j = 0; j < 4; ++j) mma_rows<BN>(acc, cur[j], xs + 32 * j);\n",
     "    if (u != 1)\n"
     "    for (int j = 0; j < 4; ++j) mma_rows<BN>(acc, cur[j], xs + 32 * j);\n",
     ("w8a16_gemm",)),
    ("gemm_cluster_dropped_rank", "w8a16_gemm.cu",
     "        for (int q = 0; q < CL; ++q) {   // ranks in order\n",
     "        for (int q = 0; q < CL; ++q) {   // ranks in order\n"
     "          if (q == 1) continue;\n", ("w8a16_gemm",)),
    ("gemm_f32_skipped_k_tile", "w8a16_gemm.cu",
     "for (int k0 = 0; k0 < K; k0 += FBK)",
     "for (int k0 = FBK; k0 < K; k0 += FBK)", ("w8a16_gemm",)),
    ("gemm_ring_guard_off", "w8a16_gemm.cu",
     "        if (pos >= STAGES)\n",
     "        if (false)\n", ("w8a16_gemm",)),
    ("grammar_flipped_bit", "grammar_mask.cu",
     "a.out[(long long)srow[j + g] * a.words + word] = bits;",
     "a.out[(long long)srow[j + g] * a.words + word] = bits ^ 0x100u;",
     ("grammar_mask",)),
    ("grammar_row_dropped", "grammar_mask.cu",
     "st[g] = g < m ? sstate[j + g] : 0;",
     "st[g] = g < m - 1 ? sstate[j + g] : 0;", ("grammar_mask",)),
    ("grammar_failsafe_off", "grammar_mask.cu",
     "const bool ok_eos = a.accept[s] != 0 || !any;",
     "const bool ok_eos = a.accept[s] != 0 || (!any && false);",
     ("grammar_mask",)),
    ("grammar_scratch_kept", "grammar_mask.cu",
     "atomicExch(a.any_ok + r, 0)", "atomicOr(a.any_ok + r, 0)",
     ("grammar_mask",)),
    ("sampler_mask_unconstrained", "sample_slots.cu",
     "const bool masked = MASK && a.mask_states[r] > 0;",
     "const bool masked = MASK;", ("sample_slots", "grammar_mask")),
    ("sampler_advance_short", "sample_slots.cu",
     "for (int l = 0; l < n; ++l) gs = a.table",
     "for (int l = 0; l + 1 < n; ++l) gs = a.table", ("sample_slots",)),
    ("sampler_top_tie_high", "sample_slots.cu",
     "constexpr bool kTopLowFirst = true;",
     "constexpr bool kTopLowFirst = false;", ("sample_slots",)),
    ("lora_wrong_slot", "lora.cu",
     "const int s = p.slots[row / p.S];",
     "const int s = p.slots[row / p.S] % 3;", ("lora", "parity_lora")),
    ("lora_base_rows_written", "lora.cu",
     "return s != 0 ? s : -1;", "return s != 0 ? s : 1;",
     ("lora", "parity_lora")),
    ("lora_split_dropped", "lora.cu",
     "const int nk = p.P;", "const int nk = p.P - 1;",
     ("lora", "parity_lora")),
    ("lora_target_shifted", "lora.cu",
     "const int yt = t;", "const int yt = (t + 1) % p.nt;",
     ("lora", "parity_lora")),
    # head_dim 256 and Gemma's vocabulary
    ("flash_hd256_wrong_q_step", "flash_prefill.cu",
     "        ldmatrix_x4(qa + kk * 16, a[0], a[1], a[2], a[3]);",
     "        ldmatrix_x4(qa + (kk ^ 1) * 16, a[0], a[1], a[2], a[3]);",
     ("flash_prefill",)),
    ("flash_hd256_q_in_the_ring", "flash_prefill.cu",
     "ring + (F::QREG ? NS - 1 : NS) * F::STAGE;",
     "ring + (NS - 1) * F::STAGE;", ("flash_prefill",)),
    ("walk_f32_split_start", "common.cuh",
     "const int tb = split * steps;", "const int tb = split * tiles;",
     ("parity_gemma",)),
    ("walk_hd256_merge_row", "common.cuh",
     "      const int row = tg * QGB + jr0 + 8 * h;",
     "      const int row = tg * QGB + jr0 + 8 * h"
     " + (HD > 128 && tg == 3 && jr0 == 0);",
     ("ragged_paged_attention", "ragged_paged_attention_int8",
      "ragged_decode")),
    ("flash_f32_hd256_short_dot", "flash_prefill.cu",
     "    for (int d = 0; d < HD; ++d) {",
     "    for (int d = 0; d < (HD > 128 ? HD - 8 : HD); ++d) {",
     ("parity_gemma",)),
    ("grammar_gemma_words_flipped", "grammar_mask.cu",
     "a.out[(long long)srow[j + g] * a.words + word] = bits;",
     "a.out[(long long)srow[j + g] * a.words + word] ="
     " word >= 4008 ? bits ^ 0x100u : bits;", ("grammar_mask",)),
    ("sampler_z_over_all", "sample_slots.cu",
     "zpart += s >= thr_k ? expf(s - m) : 0.f;", "zpart += expf(s - m);",
     ("sample_slots",)),
    ("lora_dropped_rank", "lora.cu",
     "        if (j < p.r) {\n          src = static_cast<const bf16*>",
     "        if (j + 1 < p.r) {\n          src = static_cast<const bf16*>",
     ("lora",)),
    # the multi-step decode's running mask dropped: a suspect token no
    # longer pauses its slot (the streams stay equal: the host replay is
    # the stop truth; the pause check must fail)
    ("multi_running_dropped", "engine/engine.py",
     "running = running & ~(has_stop & suspect[ring].any(dim=1))",
     "running = running | (has_stop & suspect[ring].any(dim=1))",
     ("parity_multi",)),
    # KV movement: an import that swaps a slot's first two pages (the
    # page round trip and the handed-off streams must fail), and an
    # evacuation snapshot that drops the seed's position (the resumed
    # draws restart their keys: the resumed stream must differ)
    ("import_pages_swapped", "engine/kv_cache.py",
     "    dst = page_ids.to(device=cache.k.device, dtype=torch.long)\n",
     "    dst = page_ids.to(device=cache.k.device, dtype=torch.long)\n"
     "    dst = torch.cat([dst[1:2], dst[:1], dst[2:]])\n",
     ("parity_disagg",)),
    ("evac_position_dropped", "engine/scheduler.py",
     '            "generated": len(job.gen_ids),\n            "resume": True,',
     '            "generated": 1,\n            "resume": True,',
     ("parity_disagg",)),
    # the retrieval half: the embedder's mask drops each text's last
    # token; the reranker types its separator as passage; the IVF search
    # scores deleted rows (they surface as holes in the top-10)
    ("encoder_mask_last_token_dropped", "encoders/embedder.py",
     "mask[r, :len(seq)] = True", "mask[r, :len(seq) - 1] = True",
     ("parity_encoders",)),
    ("reranker_separator_typed_passage", "encoders/reranker.py",
     "types[r, len(q) + 1:len(seq)] = 1", "types[r, len(q):len(seq)] = 1",
     ("parity_encoders",)),
    ("ivf_valid_mask_dropped", "retrieval/store.py",
     "ok = (ids >= 0) & valid[ids.clamp(min=0)]", "ok = ids >= 0",
     ("parity_encoders",)),
)

_FAULT_PHASES = """
import json, sys, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cs.CHECK_ONLY = True
dev = torch.device("cuda")
if {"parity_lora", "parity_gemma", "parity_multi",
        "parity_disagg"} & set(sys.argv[1:]):
    cs.phase_build(gemm_report=False)   # every library at once
phases = {"flash_prefill": cs.flash_cases(dev),
          "ragged_paged_attention": cs.ragged_cases(dev),
          "ragged_paged_attention_int8": cs.ragged_cases(dev, True),
          "ragged_decode": cs.decode_cases(dev),
          "sample_slots": cs.sample_cases(dev),
          "grammar_mask": cs.grammar_cases(dev),
          "w8a16_gemm": cs.gemm_cases(dev),
          "lora": cs.lora_cases(dev),
          "parity_lora": cs.parity_lora_cases(dev),
          "parity_gemma": cs.parity_gemma_cases(dev),
          "parity_multi": cs.parity_multi_cases(dev),
          "parity_disagg": cs.parity_disagg_cases(dev),
          "parity_encoders": cs.parity_encoders_cases(dev)}
out, dead = {}, False
for name in sys.argv[1:]:
    out[name] = {}
    for case, fn in phases[name].items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name][case] = "passed"
        except cs.KernelMismatch as exc:
            out[name][case] = exc.reading
        except RuntimeError as exc:
            if "CUDA" not in str(exc):
                raise
            # a launch failed (a trapped wait): the process's context is
            # gone, so the phase's later cases cannot run
            out[name][case] = {"cuda_error": str(exc)[:300]}
            dead = True
            break
        torch.cuda.empty_cache()
    if dead:
        break
print(json.dumps(out))
"""


_AB_PHASES = """
import importlib.util, json, sys, torch
tree, smoke, parts = sys.argv[1:4]
parts = parts.split(",")
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
cs.phase_build(gemm_report=False)
out = {}
if "attention" in parts:
    for name, first, fn in (
            ("flash_prefill", "chunks4", lambda: cs.phase_flash(dev)),
            ("ragged_paged_attention", "decode", lambda: cs.phase_ragged(dev)),
            ("ragged_paged_attention_int8", "decode",
             lambda: cs.phase_ragged(dev, True)),
            ("ragged_decode", "decode", lambda: cs.phase_decode(dev))):
        res = fn()
        out[name] = {first: res["ms"]}
        out[name].update({sub: res[sub]["ms"] for sub in (
            "prefill_group8", "prefix_suffix") + cs.RAGGED_SUBCASES
            if sub in res})
if "sampling" in parts:
    out["sampling_call"] = cs.ab_sampling_calls(dev)
if "gemm" in parts:
    out["w8a16_gemm"] = cs.ab_gemm(dev)
if "grammar" in parts:
    out["grammar_mask"] = cs.ab_grammar(dev)
if "lora" in parts:
    out["lora"] = cs.ab_lora(dev)
if not set(parts) & {"attention", "sampling", "gemm", "host"}:
    print(json.dumps(out))
    sys.exit(0)
cfg, params, _ = cs.draw_8b(dev)
if "host" in parts:
    lines = {}
    cs.emit = lambda phase, **fields: lines.update({phase: fields})
    keep = ("gen_tok_s", "wall_s", "completion_tokens", "server_ttft_s")
    for name, narrow in (("serve", False), ("serve_two_dispatch", True)):
        _, core = cs.phase_serve(dev, cfg, params, narrow=narrow)
        out[name] = {key: lines[name][key] for key in keep}
        if not narrow:
            del core
            torch.cuda.empty_cache()
    prof = cs.profile_decode(core)
    out["profile"] = {key: prof[key] for key in (
        "decode_ms_per_step", "device_ms_per_step", "device_busy_share")}
if "attention" in parts:
    prof = cs.profile_prefill(cs.serving_core(dev, cfg, params))
    out["profile_prefill"] = {key: prof[key] for key in (
        "host_wall_ms", "device_ms", "device_ms_by_class")}
if "sampling" in parts:
    out["profile_sampled"] = cs.profile_sampled(dev, cfg, params)
if "gemm" in parts:
    prof = cs.profile_w8(cs.serving_core(dev, cfg, params, quant="int8",
                                         **cs.NARROW), None)
    out["profile_w8"] = {key: prof[key] for key in (
        "prefill_s", "decode_ms_per_step", "device_ms_per_step",
        "device_busy_share", "device_ms_per_step_by_class", "gemm_ms_a_step",
        "gemm_share_of_bound")}
print(json.dumps(out))
"""
AB_PARTS = ("attention", "sampling", "gemm", "grammar")
AB_NAMED_ONLY = ("lora", "host")    # parts run only when named


def ab(trees, parts=AB_PARTS) -> None:
    """Kernel times of two trees of the port in one call, in turns (first,
    second, second, first), each in its own process building its own
    kernels; the cases and the timing are this script's for both.
    ``parts``: "attention" (every attention kernel and the grouped prefill
    dispatch's profile at llama3-8b, bf16 pool), "sampling" (the sampling
    call at the sampler's cases and ``profile_sampled``), "gemm" (every
    W8A16 GEMM case's device ms and host us a call, and ``profile_w8``),
    "grammar" (``ab_grammar``: the grammar mask's seven inputs and the
    sampler's option cases with a mask), "lora" (``ab_lora``: every LoRA
    case; both trees must have the kernel, so it runs only when
    named), "host" (named alone: each tree's own ``serve`` and
    ``serve_two_dispatch`` traffic and ``profile``'s decode step, the
    host work a dispatch of two versions of the Scheduler)."""
    unknown = set(parts) - set(AB_PARTS + AB_NAMED_ONLY)
    if unknown:
        raise AssertionError(f"no A/B part named {sorted(unknown)}")
    if "host" in parts and len(parts) > 1:
        raise AssertionError("the host part runs alone")
    order = [trees[0], trees[1], trees[1], trees[0]]
    runs = []
    for tree in order:
        tree = os.path.abspath(tree)
        smoke = (os.path.join(tree, "chip_smoke.py") if "host" in parts
                 else os.path.abspath(__file__))
        run = subprocess.run([sys.executable, "-c", _AB_PHASES, tree,
                              smoke, ",".join(parts)],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            raise AssertionError(f"A/B run in {tree} failed\n"
                                 f"{run.stderr[-4000:]}")
        runs.append({"tree": tree,
                     "ms": json.loads(run.stdout.strip().splitlines()[-1])})
    emit("ab", order=order, parts=list(parts), runs=runs)


# csrc/lora.cu's design choices, each undone in a temporary copy by
# ``--lora-variants``: (name, [(text, replacement), ...], what it shows)
LORA_VARIANTS = (
    ("steps_one_by_one", [("      if (WK == 1) {", "      if (false) {")],
     "the prefill shrink's fragments loaded step by step, each mma waiting "
     "on its ldmatrix"),
    ("no_x_bytes", [("        const bool ok = kin && src != nullptr;",
                     "        const bool ok = kin && src != nullptr "
                     "&& r >= rows;")],
     "the shrink reading no x at all (zeros; the results are wrong): what "
     "its steps cost without x's bytes"),
    ("four_stages", [("constexpr int STAGES = 3;",
                      "constexpr int STAGES = 4;")],
     "a fourth stage in the shrink's ring"),
    ("serial_expand", [('  asm volatile("griddepcontrol.launch_dependents;'
                        '\\n" ::: "memory");\n', ""),
                       ("programmaticStreamSerializationAllowed = 1",
                        "programmaticStreamSerializationAllowed = 0")],
     "the expand launched only once the shrink has ended"),
)
LORA_VARIANT_CASES = ("down_r16_r8_mixed", "qkv_group_r16_r8_mixed",
                      "wq_wo_r16_r4096_mixed", "down_r16_r4096_mixed",
                      "qkv_group_r16_r4096_mixed")

_LORA_VARIANT_RUN = """
import json, sys, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
print(json.dumps(cs.lora_variant_times(torch.device("cuda"))))
"""


def lora_split_us(fn, calls=20):
    """Device us a call of ``fn`` by kernel (the shrink, the expand) under
    torch.profiler, after a warm call. The expand starts while the shrink
    runs, so the two may overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"shrink": 0.0, "expand": 0.0}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            for key in out:
                if f"lora_{key}" in ev.name:
                    out[key] += ev.time_range.elapsed_us() / calls
    return out


def lora_variant_times(dev):
    """``LORA_VARIANT_CASES``' device ms a call (CUDA-graph replays) and
    their shrink and expand split, unchecked (a variant may be wrong by
    design)."""
    import torch
    from generativeaiexamples_tpu_torch.ops.cuda import lora as cl
    shapes, out = lora_case_shapes(), {}
    for tag in LORA_VARIANT_CASES:
        shape, r, rows, mix, dt, seed = shapes[tag]
        K, Os = LORA_SHAPES[shape]
        R, S = LORA_ROWS[rows]
        ys, x, a, b, slots = lora_group_inputs(dev, K, Os, r, R, S, mix,
                                               getattr(torch, dt), seed)
        fn = lora_call(cl, ys, x, a, b, slots)
        out[tag] = {"ms": graph_ms(fn, target_ms=100.0),
                    "split_us": lora_split_us(fn)}
        del ys, x, a, b, slots
        torch.cuda.empty_cache()
    return out


def lora_variants() -> None:
    """Time ``LORA_VARIANT_CASES`` for the tree as it is and for each of
    ``LORA_VARIANTS`` in a temporary copy, one process each (each builds
    its own LoRA library), in the order given."""
    import shutil
    import tempfile
    runs = {}
    for name, edits, what in (("as_is", [], "the tree as it is"),
                              *LORA_VARIANTS):
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copy(os.path.join(HERE, "chip_smoke.py"), tmp)
            pkg = os.path.join(tmp, "generativeaiexamples_tpu_torch")
            shutil.copytree(os.path.join(HERE, "generativeaiexamples_tpu_torch"),
                            pkg, ignore=shutil.ignore_patterns("__pycache__"))
            path = os.path.join(pkg, "csrc", "lora.cu")
            with open(path) as fh:
                code = fh.read()
            for text, repl in edits:
                if code.count(text) != 1:
                    raise AssertionError(f"variant {name}: text not found "
                                         f"once in lora.cu")
                code = code.replace(text, repl)
            with open(path, "w") as fh:
                fh.write(code)
            run = subprocess.run([sys.executable, "-c", _LORA_VARIANT_RUN],
                                 cwd=tmp, capture_output=True, text=True,
                                 timeout=900)
        if run.returncode != 0:
            raise AssertionError(f"variant {name} failed\n"
                                 f"{run.stderr[-4000:]}")
        runs[name] = {"what": what, "cases": json.loads(
            run.stdout.strip().splitlines()[-1])}
    emit("lora_variants", runs=runs)


def planted_faults(only=()) -> None:
    """Plant each of PLANTED_FAULTS (or those named in ``only``) in a
    temporary copy of the port, build there the libraries its phases use
    and run every case of the kernel phases it touches, checks only: each
    phase must fail at least one case's check under each of its faults,
    and each case must fail under at least one fault. Emits what each
    check read."""
    import shutil
    import tempfile
    caught = {}                  # "phase:case" -> the faults that failed it
    unknown = set(only) - {f[0] for f in PLANTED_FAULTS}
    if unknown:
        raise AssertionError(f"no planted fault named {sorted(unknown)}")
    for name, src, text, repl, phases in PLANTED_FAULTS:
        if only and name not in only:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            # the corpus too: the grammar cases' tokenizer is learned from
            # it, and another tokenizer would give the cases other masks
            for fname in ("chip_smoke.py",) + CORPUS_FILES:
                if os.path.exists(os.path.join(HERE, fname)):
                    shutil.copy(os.path.join(HERE, fname), tmp)
            pkg = os.path.join(tmp, "generativeaiexamples_tpu_torch")
            shutil.copytree(os.path.join(HERE, "generativeaiexamples_tpu_torch"),
                            pkg, ignore=shutil.ignore_patterns("__pycache__"))
            # a kernel source by name, a module of the port by its path
            path = os.path.join(pkg, src if "/" in src else
                                os.path.join("csrc", src))
            with open(path) as fh:
                code = fh.read()
            if code.count(text) != 1:
                raise AssertionError(f"fault {name}: text not found once in "
                                     f"{src}")
            with open(path, "w") as fh:
                fh.write(code.replace(text, repl))
            run = subprocess.run([sys.executable, "-c", _FAULT_PHASES,
                                  *phases], cwd=tmp, capture_output=True,
                                 text=True, timeout=900)
        if run.returncode != 0:
            raise AssertionError(f"fault {name}: run failed\n"
                                 f"{run.stderr[-4000:]}")
        readings = json.loads(run.stdout.strip().splitlines()[-1])
        emit("planted_fault", fault=name, file=src, readings=readings)
        missed = [p for p, cases in readings.items()
                  if all(r == "passed" for r in cases.values())]
        if missed:
            raise AssertionError(f"fault {name} passed the checks of {missed}")
        for phase, cases in readings.items():
            for case, reading in cases.items():
                caught.setdefault(f"{phase}:{case}", [])
                if reading != "passed":
                    caught[f"{phase}:{case}"].append(name)
    emit("planted_faults", caught_by=caught)
    # every case failing under some fault is a property of the whole set:
    # a run of named faults checks only that each of them is caught
    uncaught = [case for case, faults in caught.items() if not faults]
    if uncaught and not only:
        raise AssertionError(f"no planted fault failed the checks of "
                             f"{uncaught}")


def serve_qos_alone(dev, smi) -> None:
    """``serve_qos`` without the rest of the smoke: the kernels built,
    llama3-8b drawn and an engine core warmed as ``serve_chain_server``
    makes its own (``--serve-qos``)."""
    timed("build", phase_build, gemm_report=False)
    cfg, params, init_s = draw_8b(dev)
    emit("weights", model="llama3-8b", dtype="bfloat16", init_weights_s=init_s)
    tok = smoke_tokenizer()["tok"]
    core = serving_core(dev, cfg, params, eos_id=tok.eos_id)
    core.warmup()
    timed("serve_qos", phase_serve_qos, dev, cfg, params, smi, tok=tok,
          core=core)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import generativeaiexamples_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the PyTorch port is not beside this script "
              f"({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_device()
    if sys.argv[1:2] in (["--planted-faults"], ["--ab"],
                         ["--lora-variants"], ["--serve-qos"]):
        if sys.argv[1] == "--ab":
            ab(sys.argv[2:4], sys.argv[4:] or AB_PARTS)
        elif sys.argv[1] == "--lora-variants":
            lora_variants()
        elif sys.argv[1] == "--serve-qos":
            serve_qos_alone(dev, smi)
        else:
            planted_faults(sys.argv[2:])
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    timed("build", phase_build)
    results = {"flash_prefill": timed("kernel:flash_prefill", phase_flash,
                                      dev)}
    for quant in (False, True):
        res = timed("kernel:ragged_paged_attention"
                    + ("_int8" if quant else ""), phase_ragged, dev, quant)
        results[res["name"]] = res
    results["ragged_decode"] = timed("kernel:ragged_decode", phase_decode,
                                     dev)
    torch.cuda.empty_cache()
    results["sample_slots"] = timed("kernel:sample_slots", phase_sample, dev)
    torch.cuda.empty_cache()
    results["grammar_mask"] = timed("kernel:grammar_mask", phase_grammar,
                                    dev)
    torch.cuda.empty_cache()
    results["lora"] = timed("kernel:lora", phase_lora, dev)
    torch.cuda.empty_cache()
    results["w8a16_gemm"] = timed("kernel:w8a16_gemm", phase_gemm, dev)
    torch.cuda.empty_cache()
    timed("parity", phase_parity, dev)
    torch.cuda.empty_cache()
    timed("parity_w8", phase_parity_w8, dev)
    torch.cuda.empty_cache()
    timed("parity_lora", phase_parity_lora, dev)
    torch.cuda.empty_cache()
    paths = {"dense_lora": timed("dense_lora", phase_dense_lora, dev)}
    torch.cuda.empty_cache()
    timed("parity_gemma", phase_parity_gemma, dev)
    torch.cuda.empty_cache()
    paths["parity_moe"] = timed("parity_moe", phase_parity_moe, dev)
    torch.cuda.empty_cache()
    timed("parity_block", phase_parity_block, dev)
    torch.cuda.empty_cache()
    timed("parity_multi", phase_parity_multi, dev)
    torch.cuda.empty_cache()
    timed("parity_disagg", phase_parity_disagg, dev)
    torch.cuda.empty_cache()
    timed("parity_encoders", phase_parity_encoders, dev)
    torch.cuda.empty_cache()
    timed("retrieval_ivf", phase_retrieval_ivf, dev)
    # gemma-7b and mixtral-8x7b before llama3-8b's weights are drawn: the
    # sets would not share the card with serve's pools
    paths["serve_gemma"] = timed("serve_gemma", phase_serve_gemma, dev)
    torch.cuda.empty_cache()
    paths["serve_moe"] = timed("serve_moe", phase_serve_moe, dev)
    torch.cuda.empty_cache()
    cfg, params, init_s = draw_8b(dev)
    emit("weights", model="llama3-8b", dtype="bfloat16", init_weights_s=init_s)
    for kv_quant, tag in (("none", ""), ("int8", "_int8")):
        paths["serve" + tag], core = timed("serve" + tag, phase_serve, dev,
                                           cfg, params, kv_quant,
                                           planes=kv_quant == "none")
        if kv_quant == "none":
            # the int8 pool's W = 5 and mixed profiles were cut to keep
            # the smoke's time; serve_int8 still runs both paths
            emit("profile_wide", **timed("profile_wide", profile_decode,
                                         core, spec_width=5))
            del core
            torch.cuda.empty_cache()
            core = serving_core(dev, cfg, params, kv_quant, batch=12)
            emit("profile_mixed", **timed("profile_mixed", profile_mixed,
                                          core))
        del core
        torch.cuda.empty_cache()
    paths["serve_multi"] = timed("serve_multi", phase_serve_multi, dev, cfg,
                                 params)
    torch.cuda.empty_cache()
    paths["serve_disagg"] = timed("serve_disagg", phase_serve_disagg, dev,
                                  cfg, params)
    torch.cuda.empty_cache()
    paths["serve_rag"] = timed("serve_rag", phase_serve_rag, dev, cfg, params)
    torch.cuda.empty_cache()
    # serve_agents and serve_events run on serve_chain_server's engine core,
    # tokenizer and encoders
    shared = {}
    try:
        paths["serve_chain_server"] = timed(
            "serve_chain_server", phase_serve_chain_server, dev, cfg, params,
            smi, shared)
        paths["serve_agents"] = timed("serve_agents", phase_serve_agents,
                                      smi, **shared)
        paths["serve_events"] = timed("serve_events", phase_serve_events,
                                      smi, **shared)
        paths["serve_qos"] = timed("serve_qos", phase_serve_qos, dev, cfg,
                                   params, smi, **shared)
    finally:
        for name in ("emb", "rer"):
            if name in shared:
                shared[name].close()
    del shared
    gc.collect()
    torch.cuda.empty_cache()
    for kv_quant, tag in (("none", ""), ("int8", "_int8")):
        paths["serve_prefix" + tag] = timed(
            "serve_prefix" + tag, phase_serve_prefix, dev, cfg, params,
            kv_quant)
        torch.cuda.empty_cache()
    paths["serve_chain"], core = timed("serve_chain", phase_serve, dev, cfg,
                                       params, chain=True, devtime="sample")
    del core
    torch.cuda.empty_cache()
    emit("profile_sampled", **timed("profile_sampled", profile_sampled, dev,
                                    cfg, params))
    torch.cuda.empty_cache()
    paths["serve_tools"] = timed("serve_tools", phase_serve_tools, dev, cfg,
                                 params)
    torch.cuda.empty_cache()
    paths["serve_two_dispatch"], core = timed(
        "serve_two_dispatch", phase_serve, dev, cfg, params, narrow=True)
    prof_bf16 = timed("profile", profile_decode, core)
    emit("profile", **prof_bf16)
    _devtime_vs_profile(prof_bf16)
    emit("profile_prefill", **timed("profile_prefill", profile_prefill,
                                    core))
    del core
    torch.cuda.empty_cache()
    # profile_pipeline (the Scheduler's decode at depth 1 against 2) was
    # cut to keep the smoke's time
    # the int8 pool's narrow decode and prefill profiles were cut to keep
    # the smoke's time (profile_lora took their place); serve_int8 and
    # serve_prefix_int8 still run the int8 pool
    paths["dense"] = timed("dense", phase_dense, dev, cfg, params)
    torch.cuda.empty_cache()
    # per-request LoRA before serve_w8, which quantizes params in place
    adapters = smoke_adapters(dev, cfg, LORA_NAMES, torch.bfloat16, 50, 0.02)
    paths["serve_lora"], core = timed(
        "serve_lora", lambda: phase_serve(dev, cfg, params, name="serve_lora",
                                          adapters=adapters))
    # profile_wide's W = 5 step with the base model and the three adapters
    # in turn over the slots
    emit("profile_lora", **timed("profile_lora", profile_decode, core,
                                 spec_width=5, adapters=len(adapters)))
    del core
    torch.cuda.empty_cache()
    # the same adapters resident, every request the base model's
    paths["serve_lora_base"], core = timed(
        "serve_lora_base", lambda: phase_serve(
            dev, cfg, params, name="serve_lora_base", adapters=adapters,
            adapter_traffic=False))
    del adapters, core
    torch.cuda.empty_cache()
    # the checkpoint path before serve_w8, which quantizes params in place
    paths.update(timed("serve_ckpt", phase_serve_ckpt, dev, cfg, params,
                       smi))
    # int8 weights last: the engine quantizes the bf16 set in place
    paths["serve_w8"], core = timed("serve_w8", phase_serve, dev, cfg,
                                    params, quant="int8")
    del core
    torch.cuda.empty_cache()
    core = serving_core(dev, cfg, params, quant="int8", **NARROW)
    emit("profile_w8", **timed("profile_w8", profile_w8, core, prof_bf16[
        "device_ms_per_step_by_class"]["matmul"]))
    del core, params
    gc.collect()
    torch.cuda.empty_cache()
    paths["serve_70b_w8"] = timed("serve_70b_w8", phase_serve_70b, dev)
    src = "generativeaiexamples_tpu_torch/csrc/"
    tpu = "generativeaiexamples_tpu/ops/pallas/attention.py"
    # kernel -> (source, the TPU function it replaces, main path); the
    # sampler and the GEMM replace no Pallas kernel but XLA programs
    table = {
        "flash_prefill": ("flash_prefill.cu", f"{tpu}:192 (flash_prefill)",
                          "serve"),
        "ragged_paged_attention": (
            "ragged_paged.cu", f"{tpu}:445 (ragged_paged_attention)",
            "serve"),
        "ragged_paged_attention_int8": (
            "ragged_paged.cu", f"{tpu}:445 (ragged_paged_attention, int8-KV "
            "variant :331-351)", "serve_int8"),
        "ragged_decode": ("ragged_decode.cu", f"{tpu}:526 (ragged_decode)",
                          "dense"),
        "sample_slots": (
            "sample_slots.cu",
            "generativeaiexamples_tpu/ops/sampling.py:126-255 "
            "(_mask_dynamic, jax.random.categorical under jax.vmap in "
            "sample_logits_per_slot, token_logprob: an XLA program)",
            "serve"),
        "w8a16_gemm": (
            "w8a16_gemm.cu",
            "generativeaiexamples_tpu/ops/quant.py:98-104 (quant.matmul: an "
            "XLA-fused convert, no Pallas kernel)", "serve_w8"),
        "grammar_mask": (
            "grammar_mask.cu",
            "generativeaiexamples_tpu/ops/sampling.py:66-108 (grammar_mask: "
            "an XLA program, no Pallas kernel)", "serve_tools"),
        "lora": (
            "lora.cu",
            "generativeaiexamples_tpu/models/llama.py:271-303 (_maybe_lora: "
            "an XLA program, no Pallas kernel)", "serve_lora"),
    }
    kernels = []
    for name, (source, replaces, path) in table.items():
        res = results[name]
        entry = {"name": name, "route": "cuda", "source": src + source,
                 "replaces": replaces,
                 "launches": paths[path][name], "main_path": path,
                 "launches_by_path": {p: n[name] for p, n in paths.items()}}
        if entry["launches"] <= 0:
            raise AssertionError(f"{name} was not launched on its main path "
                                 f"{path}")
        keys = ("max_abs_err", "max_err_over_limit", "ms", "host_us",
                "plain_ms",
                "bound_ms", "bound_by", "share_of_bound", "library_ms",
                "splits", "scratch_bytes", "token_mismatches",
                "near_tie_rows", "bits_exact", "thr_k_mismatches",
                "cutoff_near_tie_rows", "draw_near_tie_rows", "cluster",
                "drawn_entries", "query_tiles", "plan", "options",
                "tokens_off_the_mask", "advance_mismatches",
                "top_id_mismatches", "top_max_abs_err", "top_tie_rows",
                "bit_mismatches", "constrained_rows", "walked_bytes",
                "floor_ms", "failsafe_rows", "accepting_rows",
                "base_rows_bit_equal", "adapter_rows")
        entry.update({key: res[key] for key in keys if key in res})
        for sub, val in res.items():      # the phase's other cases
            if isinstance(val, dict) and "ms" in val:
                entry[sub] = {key: val[key] for key in keys if key in val}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
