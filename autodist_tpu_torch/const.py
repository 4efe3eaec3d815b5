"""Constants and environment-variable configuration.

TPU-native analog of the reference's ``autodist/const.py`` (see
reference ``autodist/const.py:32-89``): working directories, default port
range for the coordination service, replica naming prefixes, group-leader
identity, and a typed ``ENV`` enum of environment variables.
"""
import os
import tempfile
from enum import Enum

# under the temporary directory (TMPDIR, else /tmp); launched workers get
# the chief's through ADT_WORKING_DIR, so a copied strategy lands where they
# read it
DEFAULT_WORKING_DIR = os.environ.get(
    "ADT_WORKING_DIR", os.path.join(tempfile.gettempdir(), "autodist_tpu_torch"))
DEFAULT_SERIALIZATION_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")
DEFAULT_LOG_DIR = os.path.join(DEFAULT_WORKING_DIR, "logs")
DEFAULT_TRACE_DIR = os.path.join(DEFAULT_WORKING_DIR, "traces")
DEFAULT_SNAPSHOT_DIR = os.path.join(DEFAULT_WORKING_DIR, "snapshots")
DEFAULT_CHECKPOINT_DIR = os.path.join(DEFAULT_WORKING_DIR, "checkpoints")
DEFAULT_BLACKBOX_DIR = os.path.join(DEFAULT_WORKING_DIR, "blackbox")

# Port range for the coordination service (analog of the reference's TF
# server ports 15000-16000, reference autodist/const.py:36-38).
DEFAULT_PORT_RANGE = iter(range(15000, 16000))
DEFAULT_COORDINATOR_PORT = 15999   # jax.distributed coordination
DEFAULT_COORDSVC_PORT = 15998      # native coordination service (barriers/staleness)

# Naming prefixes (analog of replica name-scope prefixes,
# reference autodist/const.py:40-44).
REPLICA_PREFIX = "adt-replica-{}"
SHARD_SUFFIX = "/part_{}"
GROUP_LEADER = "/job:worker/replica:0/task:0"

# Mesh axis names used throughout the framework.
DATA_AXIS = "data"           # data-parallel axis (replicas)
MODEL_AXIS = "model"         # tensor/model-parallel axis
PIPELINE_AXIS = "pipe"       # pipeline-parallel axis
SEQUENCE_AXIS = "seq"        # sequence/context-parallel axis
EXPERT_AXIS = "expert"       # expert-parallel axis

MAX_INT32 = 2 ** 31 - 1
MAX_INT64 = 2 ** 63 - 1


class ENV(Enum):
    """Typed environment variables (analog of reference autodist/const.py:55-89).

    Each member's value is a lambda producing the parsed value; access via
    ``ENV.NAME.val``.
    """

    ADT_WORKER = ("ADT_WORKER", str, "")                  # non-empty => this process is a worker, value = its address
    ADT_STRATEGY_ID = ("ADT_STRATEGY_ID", str, "")        # strategy id assigned by chief
    # how long a chief-launched worker polls for the chief's strategy file
    # (seconds): it bounds the chief's whole build and the copy
    ADT_STRATEGY_WAIT_S = ("ADT_STRATEGY_WAIT_S", float, 600.0)
    ADT_MIN_LOG_LEVEL = ("ADT_MIN_LOG_LEVEL", str, "INFO")
    ADT_IS_TESTING = ("ADT_IS_TESTING", bool, False)      # enables extra invariant checks
    ADT_DEBUG_REMOTE = ("ADT_DEBUG_REMOTE", bool, False)  # suppress real SSH exec (dry-run)
    ADT_PATCH_OPTAX = ("ADT_PATCH_OPTAX", bool, True)     # record optimizer construction info
    ADT_INTERNAL_BACKEND = ("ADT_INTERNAL_BACKEND", str, "")
    SYS_DATA_PATH = ("SYS_DATA_PATH", str, "")
    SYS_RESOURCE_PATH = ("SYS_RESOURCE_PATH", str, "")
    ADT_COORDINATOR_ADDR = ("ADT_COORDINATOR_ADDR", str, "")  # host:port of chief coordination service
    ADT_NUM_PROCESSES = ("ADT_NUM_PROCESSES", int, 1)
    ADT_PROCESS_ID = ("ADT_PROCESS_ID", int, 0)
    # a launched process's device entry in the resource spec, "cuda:<listed
    # index>" or "cpu" (runtime/cluster.py worker_env; the chief's own is
    # set at its launch)
    ADT_DEVICE = ("ADT_DEVICE", str, "")
    # set (on every process) by external launchers (GKE/mpirun style) that
    # start all processes simultaneously; switches the strategy handoff from
    # chief-writes-file-then-launches-workers to a collective broadcast
    ADT_EXTERNAL_LAUNCH = ("ADT_EXTERNAL_LAUNCH", bool, False)
    # coordination-service port override (tests / colocated jobs); read at
    # access time like every other ADT_* var, not frozen at import
    ADT_COORDSVC_PORT = ("ADT_COORDSVC_PORT", int, DEFAULT_COORDSVC_PORT)
    # async-PS backpressure: max gradient blobs in flight per owner queue
    # before push blocks; 0 disables
    # the client-side pacing, but the coordination service still enforces
    # a hard 4096-entry queue cap (qpush raises past it) so a dead owner
    # can never eat the host's memory
    ADT_PS_MAX_LAG = ("ADT_PS_MAX_LAG", int, 2)
    # every N steps, sync multi-process PS compares a digest of the host
    # mirrors across processes via the coordination service (0 = off);
    # catches silent mirror divergence from heterogeneous host codegen
    ADT_PS_MIRROR_CHECK_EVERY = ("ADT_PS_MIRROR_CHECK_EVERY", int, 0)
    # comma-separated mesh axis names to treat as DCN (cross-host) for the
    # spec=DCN hierarchical reduce; default: detected from process layout
    ADT_DCN_AXES = ("ADT_DCN_AXES", str, "")
    # elastic jobs: max RESTARTS per worker (async PS) or of the whole job
    # (with ADT_ELASTIC_SYNC) before the chief fail-fasts (0 = reference
    # fail-fast semantics). Async-elastic jobs join no process group —
    # async PS couples processes only through the parameter service, which
    # is what makes a worker restartable at all; sync strategies are
    # collective-lockstep and restart whole from a checkpoint instead.
    ADT_ELASTIC = ("ADT_ELASTIC", int, 0)
    # liveness window (seconds): workers heartbeat every quarter of it;
    # the chief's watchdog treats silence longer than it as death/deadlock
    ADT_HEARTBEAT_TIMEOUT_S = ("ADT_HEARTBEAT_TIMEOUT_S", float, 60.0)
    # sync-elastic bring-up: with ADT_ELASTIC, declares the job's strategy
    # SYNCHRONOUS so processes still join the process group (lockstep
    # collectives need every rank; recovery is whole-job re-exec with a
    # fresh process set, not per-worker rejoin)
    ADT_ELASTIC_SYNC = ("ADT_ELASTIC_SYNC", bool, False)
    # in-run elastic reconfiguration (runtime/elastic.py): with
    # ADT_ELASTIC_SYNC, a confirmed sync-worker death shrinks the job to
    # the survivors IN-RUN (epoch-fenced membership, jax.distributed
    # rejoin, in-memory re-shard) instead of the whole-job re-exec; a
    # relaunched worker grows it back. Validated loudly at bring-up
    # (elastic.validate_elastic_knobs).
    ADT_ELASTIC_INRUN = ("ADT_ELASTIC_INRUN", bool, False)
    # chief-side escalation: how long to wait for every survivor's
    # elastic/ack/<epoch> after publishing a shrink before falling back
    # to the whole-job checkpoint-restore restart (a survivor wedged in a
    # collective the dead worker will never re-enter cannot reach its
    # reconfiguration boundary)
    ADT_ELASTIC_ACK_TIMEOUT_S = ("ADT_ELASTIC_ACK_TIMEOUT_S", float, 120.0)
    # how often the Runner polls the membership epoch at readback
    # boundaries (seconds; bounds reconfiguration downtime from above)
    ADT_ELASTIC_POLL_S = ("ADT_ELASTIC_POLL_S", float, 0.5)
    # in-run elastic: each node's number of device entries in the job's
    # resource spec (``node=count,...``), which the chief passes to the
    # processes it launches, so that a relaunched worker expands an
    # epoch's roster of nodes into ranks before it has read the spec
    ADT_ELASTIC_ENTRIES = ("ADT_ELASTIC_ENTRIES", str, "")
    # sync-elastic recovery (runtime/coordinator.py _restart_whole_job):
    # set on the re-exec'd job so Runner.init restores the latest
    # checkpoint from ADT_CKPT_DIR instead of starting fresh. Users can
    # also set it for at-most-once resume semantics on any job.
    ADT_AUTO_RESUME = ("ADT_AUTO_RESUME", bool, False)
    # checkpoint directory the auto-resume (and its periodic saves) use
    ADT_CKPT_DIR = ("ADT_CKPT_DIR", str, DEFAULT_CHECKPOINT_DIR)
    # sync-elastic reduced-world restart: comma-separated worker addresses
    # treated as PERMANENTLY lost — AutoDist drops them from the resource
    # spec at construction, so the restarted job runs at reduced world
    # size (the cross-topology sharded restore reassembles state). Set by
    # the coordinator when a worker's death triggers two consecutive
    # whole-job restarts; can also be set by hand to decommission a host.
    ADT_ELASTIC_EXCLUDE = ("ADT_ELASTIC_EXCLUDE", str, "")
    # what the sync-elastic whole-job restart carries across its re-exec
    # of the chief (the JAX package reads them as raw os.environ): the
    # restarts spent so far, and the node whose death caused the last one
    # with the newest checkpoint step at that time (a second death of the
    # same node with no newer checkpoint excludes it)
    ADT_ELASTIC_RESTARTS = ("ADT_ELASTIC_RESTARTS", int, 0)
    ADT_ELASTIC_LAST_DEAD = ("ADT_ELASTIC_LAST_DEAD", str, "")
    ADT_ELASTIC_LAST_DEAD_STEP = ("ADT_ELASTIC_LAST_DEAD_STEP", int, -1)
    # ---- preemption plane (runtime/preemption.py): advance-notice
    # graceful departure. Default grace window a SIGTERM notice budgets
    # when the sender attached no explicit deadline (seconds — TPU
    # maintenance gives minutes, spot VMs ~30s); the rescue checkpoint is
    # skipped when the remaining budget is below the measured save p99.
    # Validated loudly (preemption.validate_preempt_knobs).
    ADT_PREEMPT_DEADLINE_S = ("ADT_PREEMPT_DEADLINE_S", float, 30.0)
    # how often Runners poll the preempt/<worker> notice marks at
    # readback boundaries (piggybacked on the elastic epoch poll;
    # 0 disables the KV poll — local SIGTERM notices still work)
    ADT_PREEMPT_POLL_S = ("ADT_PREEMPT_POLL_S", float, 1.0)
    # Retry-After (seconds) a draining serving tier attaches to its typed
    # sheds, so load balancers re-route instead of hammering the leaver
    ADT_DRAIN_RETRY_AFTER_S = ("ADT_DRAIN_RETRY_AFTER_S", float, 5.0)
    # FleetAutoscaler.start() control-loop period (seconds): how often the
    # serving autoscaler samples queue depth/p99 and re-decides; the
    # policy's sustain window and cooldowns gate actual scale events, so
    # a fast poll sharpens reaction time without causing flap
    ADT_AUTOSCALE_POLL_S = ("ADT_AUTOSCALE_POLL_S", float, 2.0)
    # cloud maintenance-event poll hook: a path whose EXISTENCE signals a
    # pending maintenance eviction for this host (its JSON body may carry
    # {"deadline_s": ..., "reason": ...}). Cloud integrations materialize
    # the metadata-server event into this file; tests touch it directly.
    ADT_MAINTENANCE_FILE = ("ADT_MAINTENANCE_FILE", str, "")
    # ---- control-plane resilience knobs (runtime/resilience.py, the
    # failure model in docs/failure_model.md documents how they compose)
    # TCP connect timeout for every CoordinationClient (seconds)
    ADT_CONNECT_TIMEOUT_S = ("ADT_CONNECT_TIMEOUT_S", float, 5.0)
    # how long CoordinationServer.start() waits for the service to come up
    ADT_COORDSVC_START_TIMEOUT_S = ("ADT_COORDSVC_START_TIMEOUT_S", float, 5.0)
    # per-RPC deadline for the resilient client (seconds; 0 = no deadline).
    # Blocking RPCs (BARRIER / WAITMIN) are exempt — they park server-side
    # by design and retry across drops on their idempotency token instead.
    ADT_RPC_TIMEOUT_S = ("ADT_RPC_TIMEOUT_S", float, 30.0)
    # retry budget: max automatic retries per RPC after a transport error
    ADT_RPC_RETRIES = ("ADT_RPC_RETRIES", int, 5)
    # circuit breaker: consecutive transport failures that open the
    # circuit, and how long it stays open before a half-open probe
    ADT_BREAKER_FAILURES = ("ADT_BREAKER_FAILURES", int, 8)
    ADT_BREAKER_COOLDOWN_S = ("ADT_BREAKER_COOLDOWN_S", float, 5.0)
    # async-PS owner apply loop: how long it keeps trying to reconnect
    # through a service blip before declaring itself unhealthy (Runner
    # then fails the job loudly instead of stalling)
    ADT_PS_OWNER_RETRY_S = ("ADT_PS_OWNER_RETRY_S", float, 60.0)
    # declarative fault plan for the FaultyProxy harness
    # (runtime/faultinject.py): JSON, or @/path/to/plan.json
    ADT_FAULT_PLAN = ("ADT_FAULT_PLAN", str, "")
    # declarative checkpoint-lifecycle fault plan (kill-at-phase SIGKILLs,
    # post-commit file damage) executed by the savers' fault hooks
    # (runtime/faultinject.py CheckpointFaultPlan): JSON, or @/path/plan.json
    ADT_CKPT_FAULT_PLAN = ("ADT_CKPT_FAULT_PLAN", str, "")
    # declarative gradient fault plan (runtime/faultinject.py
    # GradFaultPlan): deterministic step-keyed NaN/Inf/bit-flip/scale
    # injection into a named variable's gradient, COMPILED into the
    # lowering at transform time. JSON, or @/path/plan.json
    ADT_GRAD_FAULT_PLAN = ("ADT_GRAD_FAULT_PLAN", str, "")
    # training health sentinel (runtime/sentinel.py): "" / "0" off,
    # "1" default policy, or a JSON dict of SentinelPolicy knobs —
    # compiles in-graph anomaly guards and arms skip/rollback/quarantine
    ADT_SENTINEL = ("ADT_SENTINEL", str, "")
    # watchdog grace for a worker that marked itself "compiling": a first
    # dispatch's XLA compile can legitimately exceed the heartbeat window
    ADT_COMPILE_GRACE_S = ("ADT_COMPILE_GRACE_S", float, 600.0)
    # host-PS transfer/compute overlap (parallel/ps.py PSPipeline): 1 =
    # background push + prefetched pull (bit-exact for sync PS; with
    # staleness>=1 or async serving the prefetch overlaps compute fully);
    # 0 = the serial pull->step->push baseline
    ADT_PS_OVERLAP = ("ADT_PS_OVERLAP", int, 1)
    # host-PS apply parallelism: shard updates are independent by
    # construction, so they run on a thread pool of this many workers
    # (0 = auto: min(4, cpu_count); 1 = the single-dispatch baseline).
    # Bit-exact either way — grouping never changes per-shard math.
    ADT_PS_APPLY_THREADS = ("ADT_PS_APPLY_THREADS", int, 0)
    # quantized-wire scale-block size (parallel/collectives.py): elements
    # per absmax-scale block for the int8 wire codec (wire_dtype="int8" /
    # Int8 compressors). Smaller blocks = tighter scales but a bigger f32
    # sidecar: payload bytes per element = 1 + 4/block. 256 keeps the
    # sidecar under 2% while bounding each block's quantization range.
    ADT_WIRE_BLOCK = ("ADT_WIRE_BLOCK", int, 256)
    # ---- runtime telemetry (telemetry/spans.py; docs/observability.md)
    # span tracing mode: "0" off (counters still collected), "1" record
    # every span, "sampled" record 1/ADT_TRACE_SAMPLE spans
    ADT_TRACE = ("ADT_TRACE", str, "0")
    # ring-buffer capacity (completed spans kept; oldest dropped first)
    ADT_TRACE_BUFFER = ("ADT_TRACE_BUFFER", int, 65536)
    # sampled-mode stride: record one span out of every N
    ADT_TRACE_SAMPLE = ("ADT_TRACE_SAMPLE", int, 16)
    # where bench/CLI write exported traces by default
    ADT_TRACE_FILE = ("ADT_TRACE_FILE", str, "")
    # log line format: "text" (default) or "json" (structured lines
    # carrying span ids so logs correlate with traces)
    ADT_LOG_FORMAT = ("ADT_LOG_FORMAT", str, "text")
    # ---- cluster observability plane (telemetry/cluster.py, goodput.py,
    #      blackbox.py; docs/observability.md)
    # clock-offset handshake rounds against the chief's ClockSyncResponder
    # (the min-RTT round wins; more rounds ride out jitter)
    ADT_CLOCKSYNC_ROUNDS = ("ADT_CLOCKSYNC_ROUNDS", int, 8)
    # straggler flagging: EWMA z-score threshold and consecutive-dispatch
    # patience before this worker marks itself slow-but-alive
    ADT_STRAGGLER_Z = ("ADT_STRAGGLER_Z", float, 4.0)
    ADT_STRAGGLER_PATIENCE = ("ADT_STRAGGLER_PATIENCE", int, 3)
    # serviceless fleet profiling: "N:M" captures a jax.profiler trace
    # for steps N..M (inclusive) on THIS process
    ADT_PROFILE_STEPS = ("ADT_PROFILE_STEPS", str, "")
    # how often the Runner polls the coordination service's fleet
    # profiling flag (seconds; 0 disables the poll)
    ADT_PROFILE_POLL_S = ("ADT_PROFILE_POLL_S", float, 2.0)
    # flight recorder: "1" (default) arms dumps + the SIGTERM hook; "0"
    # keeps recording in memory but never writes a file
    ADT_BLACKBOX = ("ADT_BLACKBOX", bool, True)
    ADT_BLACKBOX_DIR = ("ADT_BLACKBOX_DIR", str, DEFAULT_BLACKBOX_DIR)
    # dump at normal process exit too (postmortems for runs that end
    # "cleanly" but wrong)
    ADT_BLACKBOX_DUMP = ("ADT_BLACKBOX_DUMP", bool, False)
    # bounded retention: events kept in memory, dump files kept on disk
    ADT_BLACKBOX_EVENTS = ("ADT_BLACKBOX_EVENTS", int, 256)
    ADT_BLACKBOX_KEEP = ("ADT_BLACKBOX_KEEP", int, 8)

    @property
    def val(self):
        name, typ, default = self.value
        raw = os.environ.get(name)
        if raw is None:
            return default
        if typ is bool:
            return raw not in ("", "0", "False", "false")
        return typ(raw)

    @property
    def name_str(self):
        return self.value[0]


def is_worker() -> bool:
    """True when this process was launched by the coordinator as a worker."""
    return bool(ENV.ADT_WORKER.val)


def is_chief() -> bool:
    return not is_worker()


def makedirs():
    for d in (DEFAULT_WORKING_DIR, DEFAULT_SERIALIZATION_DIR, DEFAULT_LOG_DIR,
              DEFAULT_TRACE_DIR, DEFAULT_SNAPSHOT_DIR, DEFAULT_CHECKPOINT_DIR):
        os.makedirs(d, exist_ok=True)
