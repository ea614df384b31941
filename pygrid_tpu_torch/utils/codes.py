"""Protocol string constants — the JSON-WS/HTTP wire contract: the port's
own copy of :mod:`pygrid_tpu.utils.codes`, constant for constant.

These are the field names and event types that clients (syft.js-style edge
workers, the JAX package's SDK in ``pygrid_tpu.client``) put on the wire, so they must
be stable. Parity surface: reference ``apps/node/src/app/main/core/codes.py``
and the ``syft.codes.REQUEST_MSG``/``RESPONSE_MSG`` constants consumed at
reference ``apps/node/src/app/main/events/__init__.py:49-56``.
"""


class MSG_FIELD:
    REQUEST_ID = "request_id"
    TYPE = "type"
    DATA = "data"
    WORKER_ID = "worker_id"
    MODEL = "model"
    MODEL_ID = "model_id"
    ALIVE = "alive"
    ALLOW_DOWNLOAD = "allow_download"
    ALLOW_REMOTE_INFERENCE = "allow_remote_inference"
    MPC = "mpc"
    PROPERTIES = "model_properties"
    SIZE = "model_size"
    SYFT_VERSION = "syft_version"
    REQUIRES_SPEED_TEST = "requires_speed_test"
    USERNAME_FIELD = "username"
    PASSWORD_FIELD = "password"
    # grid-tpu additions (node identity / status payloads)
    NODE_ID = "id"
    STATUS = "status"
    NODES = "nodes"
    MODELS = "models"
    DATASETS = "datasets"
    CPU = "cpu"
    MEM = "mem"


class CONTROL_EVENTS:
    SOCKET_PING = "socket-ping"


class WEBRTC_EVENTS:
    """Vestigial in the reference (constants only, no implementation) —
    kept for protocol-constant parity (reference core/codes.py:24-27)."""

    PEER_LEFT = "webrtc: peer-left"
    INTERNAL_MSG = "webrtc: internal-message"
    JOIN_ROOM = "webrtc: join-room"


class MODEL_CENTRIC_FL_EVENTS:
    HOST_FL_TRAINING = "model-centric/host-training"
    #: WS twin of GET /model-centric/get-model — on the negotiated binary
    #: wire the checkpoint rides the same socket as the rest of the cycle
    #: (raw bytes, no base64); this framework's extension, absent in the
    #: reference (its download is HTTP-only)
    GET_MODEL = "model-centric/get-model"
    REPORT = "model-centric/report"
    #: a sub-aggregator's pre-folded subtree report — one count-weighted
    #: partial sum standing in for fanout× individual reports (this
    #: framework's hierarchical-aggregation extension, docs/AGGREGATION.md)
    REPORT_PARTIAL = "model-centric/report-partial"
    AUTHENTICATE = "model-centric/authenticate"
    CYCLE_REQUEST = "model-centric/cycle-request"
    REPORT_METRICS = "model-centric/report-metrics"
    # secure-aggregation rounds (this framework's extension — the reference
    # has no SecAgg; names follow its model-centric/<verb> convention)
    SECAGG_ADVERTISE = "model-centric/secagg-advertise"
    SECAGG_ROSTER = "model-centric/secagg-roster"
    SECAGG_SHARES = "model-centric/secagg-shares"
    SECAGG_STATUS = "model-centric/secagg-status"
    SECAGG_UNMASK = "model-centric/secagg-unmask"


class USER_EVENTS:
    GET_ALL_USERS = "list-users"
    GET_SPECIFIC_USER = "list-user"
    SEARCH_USERS = "search-users"
    PUT_EMAIL = "put-email"
    PUT_PASSWORD = "put-password"
    # the reference assigns "put-role" to BOTH this and ROLE_EVENTS.PUT_ROLE
    # (core/codes.py:43,54), which makes user-role changes unreachable in its
    # WS table; disambiguated here
    PUT_ROLE = "put-user-role"
    PUT_GROUPS = "put-groups"
    DELETE_USER = "delete-user"
    SIGNUP_USER = "signup-user"
    LOGIN_USER = "login-user"


class ROLE_EVENTS:
    CREATE_ROLE = "create-role"
    GET_ROLE = "get-role"
    GET_ALL_ROLES = "get-all-roles"
    PUT_ROLE = "put-role"
    DELETE_ROLE = "delete-role"


class GROUP_EVENTS:
    CREATE_GROUP = "create-group"
    GET_GROUP = "get-group"
    GET_ALL_GROUPS = "get-all-groups"
    PUT_GROUP = "put-group"
    DELETE_GROUP = "delete-group"


class CYCLE:
    STATUS = "status"
    KEY = "request_key"
    PING = "ping"
    DOWNLOAD = "download"
    UPLOAD = "upload"
    VERSION = "version"
    PLANS = "plans"
    PROTOCOLS = "protocols"
    CLIENT_CONFIG = "client_config"
    SERVER_CONFIG = "server_config"
    TIMEOUT = "timeout"
    DIFF = "diff"
    AVG_PLAN = "averaging_plan"
    ACCEPTED = "accepted"
    REJECTED = "rejected"


class REQUEST_MSG:
    """Data-centric verbs (the syft.codes.REQUEST_MSG surface the reference
    node's WS router dispatches on — events/__init__.py:49-56)."""

    TYPE_FIELD = "type"
    GET_ID = "get-id"
    CONNECT_NODE = "connect-node"
    HOST_MODEL = "host-model"
    RUN_INFERENCE = "run-inference"
    #: autoregressive generation from a hosted transformer bundle — no
    #: reference analog (the reference's inference surface stops at
    #: feed-forward run-inference); exists because the transformer model
    #: family does (models/decode.py)
    RUN_GENERATION = "run-generation"
    DELETE_MODEL = "delete-model"
    LIST_MODELS = "list-models"
    AUTHENTICATE = "authentication"


class RESPONSE_MSG:
    ERROR = "error"
    SUCCESS = "success"
    NODE_ID = "id"
    INFERENCE_RESULT = "prediction"
    MODELS = "models"


class NODE_EVENTS:
    """Node↔Network WS control events (reference
    apps/network/src/app/events/__init__.py:12-15)."""

    JOIN = "join"
    FORWARD = "forward"
    MONITOR = "monitor"
    MONITOR_ANSWER = "monitor-answer"


class WORKER_STATUS:
    ONLINE = "online"
    BUSY = "busy"
    OFFLINE = "offline"


#: Number of share-holding nodes allocated per SMPC model replica
#: (reference apps/network/src/app/routes/network.py:16).
SMPC_HOST_CHUNK = 4

#: Network → node monitor heartbeat interval, seconds
#: (reference apps/network/src/app/codes.py:51-56, workers/worker.py:67-74).
MONITOR_INTERVAL_S = 15.0

#: Ping threshold after which a node is considered offline.
OFFLINE_THRESHOLD_S = 60.0
