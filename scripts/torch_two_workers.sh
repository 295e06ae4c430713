#!/usr/bin/env bash
# Two workers of the PyTorch port on one card: a prefill worker and a decode
# worker, each with its own weights (the default llama3-8b, random from a
# seed) and its own pool. One prompt is prefilled on the first, its KV frame
# handed to the second, and the completion streamed from there, with the
# commands the README gives. The workers start one after the other, so each
# one's device memory is the card's used memory (nvidia-smi) after it is
# healthy less the reading before it started; the card's peak over the run
# is sampled every second. Prints the card's name and power limit and exits
# non-zero if the handoff did not stream.
#
#   bash scripts/torch_two_workers.sh [OUT_DIR]     (default build/two_workers)
#
# WORKER_ARGS adds arguments to both server launches (on the CPU:
# WORKER_ARGS="--tiny --device cpu", which reads no device memory).
set -euo pipefail
out=${1:-build/two_workers}
args=${WORKER_ARGS:-}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  || echo "nvidia-smi: not available"

used() {
  nvidia-smi --query-gpu=memory.used --format=csv,noheader,nounits \
    2>/dev/null | head -n 1 || true
}
nvidia-smi --query-gpu=memory.used --format=csv,noheader,nounits \
  -lms 1000 >"$out/total.csv" 2>/dev/null &
poll=$!
pre= dec=
trap 'kill $pre $dec $poll 2>/dev/null || true; wait' EXIT

healthy() {   # PORT PID LOG
  until curl -sf "localhost:$1/health" >/dev/null; do
    if ! kill -0 "$2" 2>/dev/null; then
      echo "the worker on port $1 exited before it was healthy" >&2
      tail -n 30 "$3" >&2
      exit 1
    fi
    sleep 2
  done
}

t0=$SECONDS
m0=$(used)
APP_ENGINE_ROLE=prefill python -m generativeaiexamples_tpu_torch.engine \
  --port 8001 $args >"$out/prefill.log" 2>&1 &
pre=$!
healthy 8001 "$pre" "$out/prefill.log"
m1=$(used)
APP_ENGINE_ROLE=decode python -m generativeaiexamples_tpu_torch.engine \
  --port 8002 $args >"$out/decode.log" 2>&1 &
dec=$!
healthy 8002 "$dec" "$out/decode.log"
m2=$(used)
echo "both workers healthy after $((SECONDS - t0)) s"

curl -s -H 'Accept: application/x-kv-frames' \
  -H 'Content-Type: application/json' \
  -d '{"prompt": "hi", "max_tokens": 16}' \
  localhost:8001/v1/kv/prefill -o "$out/kv.bin"
curl -sN -H 'Content-Type: application/x-kv-frames' --data-binary \
  @"$out/kv.bin" localhost:8002/v1/kv/handoff >"$out/handoff.sse"
curl -s localhost:8001/health >"$out/prefill_health.json"
curl -s localhost:8002/health >"$out/decode_health.json"
m3=$(used)
sleep 2
kill $pre $dec $poll 2>/dev/null || true
wait 2>/dev/null || true
trap - EXIT

python3 - "$out" "$m0" "$m1" "$m2" "$m3" <<'EOF'
import json, os, sys
out = sys.argv[1]
m0, m1, m2, m3 = (int(m) if m.isdigit() else None for m in sys.argv[2:6])
frame = os.path.getsize(os.path.join(out, "kv.bin"))
sse = open(os.path.join(out, "handoff.sse")).read()
events = [l[6:] for l in sse.splitlines() if l.startswith("data: ")]
ph = json.load(open(os.path.join(out, "prefill_health.json")))
dh = json.load(open(os.path.join(out, "decode_health.json")))
total = [int(l) for l in open(os.path.join(out, "total.csv"))
         if l.strip().isdigit()]

def diff(a, b):
    return b - a if a is not None and b is not None else None

print(json.dumps({
    "frame_bytes": frame,
    "sse_events": len(events),
    "done": bool(events) and events[-1] == "[DONE]",
    "roles": [ph.get("engine_role"), dh.get("engine_role")],
    "decode_dispatches_prefill_worker": ph.get("decode_dispatches"),
    "kv_handoff_imports_decode_worker": dh.get("kv_handoff_imports"),
    "decode_steps_decode_worker": dh.get("decode_steps"),
    "prefill_dispatches_decode_worker": dh.get("prefill_dispatches"),
    "finish_reason": [json.loads(e)["choices"][0]["finish_reason"]
                      for e in events[:-1]][-1:],
    "weight_bytes": [ph.get("weight_bytes"), dh.get("weight_bytes")],
    "kv_pool_bytes": [ph.get("kv_pool_bytes"), dh.get("kv_pool_bytes")],
    "mib_card_before": m0,
    "mib_prefill_worker": diff(m0, m1),
    "mib_decode_worker": diff(m1, m2),
    "mib_card_after_request": m3,
    "peak_mib_card": max(total) if total else None,
}))
ok = (frame > 0 and bool(events) and events[-1] == "[DONE]"
      and len(events) > 1 and dh.get("kv_handoff_imports", 0) >= 1
      and dh.get("prefill_dispatches") == 0
      and ph.get("decode_dispatches") == 0)
sys.exit(0 if ok else 1)
EOF
