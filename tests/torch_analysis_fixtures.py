"""Source trees the JAX package's gridlint tests lint, recorded by
``python tests/test_torch_analysis_parity.py`` (do not edit by hand).
Each case: its id (test file, class and test), the family it is
held under, the checker families its run selected (empty: all five
parity families), its targets and excludes, and every file."""

CASES = [{'id': 'gridlint.TestGL2.test_unlocked_mutation_fires_GL202',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestGL2.test_never_guarded_attr_is_thread_confined',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Engine:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._queue = []\n'
                          '        self._cache = None\n'
                          '\n'
                          '    def guarded(self, x):\n'
                          '        with self._lock:\n'
                          '            self._queue.append(x)\n'
                          '\n'
                          '    def engine_thread_only(self, v):\n'
                          '        # _cache is never touched under the lock anywhere —\n'
                          '        # treated as single-thread-confined by design\n'
                          '        self._cache = v\n'}},
 {'id': 'gridlint.TestGL2.test_locked_suffix_and_docstring_conventions_exempt',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Svc:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._state = {}\n'
                          '\n'
                          '    def get(self, k):\n'
                          '        with self._lock:\n'
                          '            return self._mutate_locked(k)\n'
                          '\n'
                          '    def _mutate_locked(self, k):\n'
                          '        self._state[k] = 1\n'
                          '        return 1\n'
                          '\n'
                          '    def _drop(self, k):\n'
                          '        """Under the lock: callers own it."""\n'
                          '        self._state.pop(k, None)\n'}},
 {'id': 'gridlint.TestGL2.test_lock_order_cycle_fires_GL201',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class AB:\n'
                          '    def __init__(self):\n'
                          '        self._a = threading.Lock()\n'
                          '        self._b = threading.Lock()\n'
                          '        self._x = 0\n'
                          '\n'
                          '    def one(self):\n'
                          '        with self._a:\n'
                          '            with self._b:\n'
                          '                self._x += 1\n'
                          '\n'
                          '    def two(self):\n'
                          '        with self._b:\n'
                          '            with self._a:\n'
                          '                self._x -= 1\n'}},
 {'id': 'gridlint.TestGL2.test_consistent_lock_order_is_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class AB:\n'
                          '    def __init__(self):\n'
                          '        self._a = threading.Lock()\n'
                          '        self._b = threading.Lock()\n'
                          '        self._x = 0\n'
                          '\n'
                          '    def one(self):\n'
                          '        with self._a:\n'
                          '            with self._b:\n'
                          '                self._x += 1\n'
                          '\n'
                          '    def two(self):\n'
                          '        with self._a:\n'
                          '            with self._b:\n'
                          '                self._x -= 1\n'}},
 {'id': 'gridlint.TestGL2.test_condition_alias_self_deadlock_fires_GL203',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Engine:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._work = threading.Condition(self._lock)\n'
                          '\n'
                          '    def bad(self):\n'
                          '        with self._lock:\n'
                          '            with self._work:\n'
                          '                pass\n'}},
 {'id': 'gridlint.TestGL2.test_rlock_reacquire_is_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Svc:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.RLock()\n'
                          '\n'
                          '    def reentrant(self):\n'
                          '        with self._lock:\n'
                          '            with self._lock:\n'
                          '                pass\n'}},
 {'id': 'gridlint.TestGL3.test_blocking_calls_in_async_def_fire',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          'import requests\n'
                          '\n'
                          'async def handler(request):\n'
                          '    time.sleep(0.1)\n'
                          '    requests.get("http://x")\n'
                          '    return None\n'}},
 {'id': 'gridlint.TestGL3.test_future_result_and_queue_get_fire_GL302',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'async def handler(self, request):\n'
                          '    value = self.future.result(30)\n'
                          '    item = self._q.get()\n'
                          '    return value, item\n'}},
 {'id': 'gridlint.TestGL3.test_serde_on_the_loop_fires_GL303',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import base64\n'
                          'from pygrid_tpu.serde import serialize\n'
                          '\n'
                          'async def handler(request, model):\n'
                          '    blob = serialize(model)\n'
                          '    raw = base64.b64decode(blob)\n'
                          '    return raw\n'}},
 {'id': 'gridlint.TestGL3.test_nested_sync_def_and_executor_are_quiet',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import asyncio\n'
                          'import time\n'
                          'from pygrid_tpu.serde import serialize\n'
                          '\n'
                          'def plain(model):\n'
                          '    # sync code may block: it runs wherever its caller puts it\n'
                          '    time.sleep(0.1)\n'
                          '    return serialize(model)\n'
                          '\n'
                          'async def handler(request, model):\n'
                          '    loop = asyncio.get_running_loop()\n'
                          '    blob = await loop.run_in_executor(\n'
                          '        None, lambda: serialize(model)\n'
                          '    )\n'
                          '    return await loop.run_in_executor(None, plain, model)\n'}},
 {'id': 'gridlint.TestGL3.test_one_hop_helper_call_fires_GL304',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          'from pygrid_tpu.serde import serialize\n'
                          '\n'
                          'def decode_body(model):\n'
                          '    time.sleep(0.1)\n'
                          '    return serialize(model)\n'
                          '\n'
                          'class Routes:\n'
                          '    def _validate(self, x):\n'
                          '        return self._q.get()\n'
                          '\n'
                          '    async def handler(self, request, model):\n'
                          '        self._validate(model)       # method one hop\n'
                          '        return decode_body(model)   # module helper one hop\n'}},
 {'id': 'gridlint.TestGL3.test_one_hop_helper_referenced_not_called_is_quiet',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import asyncio\n'
                          'import json\n'
                          'from pygrid_tpu.serde import serialize\n'
                          '\n'
                          'def heavy(model):\n'
                          '    return serialize(model)\n'
                          '\n'
                          'async def _off_loop(fn, *args):\n'
                          '    loop = asyncio.get_running_loop()\n'
                          '    return await loop.run_in_executor(None, fn, *args)\n'
                          '\n'
                          'async def handler(request, model):\n'
                          '    # handed to the executor, never CALLED on the loop\n'
                          '    return await _off_loop(heavy, model)\n'
                          '\n'
                          'async def clean(request):\n'
                          '    return json.dumps({"ok": True})\n'}},
 {'id': 'gridlint.TestGL3.test_one_hop_bare_call_does_not_resolve_to_class_method',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          'from pygrid_tpu.serde import serialize\n'
                          '\n'
                          'class Codec:\n'
                          '    def serialize(self):\n'
                          '        # an unrelated method shadowing the imported name —\n'
                          '        # the async handler calls the IMPORT, not this\n'
                          '        time.sleep(1)\n'
                          '\n'
                          'async def handler(request, model):\n'
                          '    return serialize(model)\n'}},
 {'id': 'gridlint.TestGL3.test_one_hop_self_call_scoped_to_own_class',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          '\n'
                          'class Blocking:\n'
                          '    def _validate(self, x):\n'
                          '        time.sleep(1)\n'
                          '\n'
                          'class Clean:\n'
                          '    def _validate(self, x):\n'
                          '        return x\n'
                          '\n'
                          '    async def handler(self, request):\n'
                          "        # Clean's own _validate — Blocking's same-named\n"
                          '        # method must not misattribute a GL304 here\n'
                          '        return self._validate(request)\n'}},
 {'id': 'gridlint.TestGL3.test_one_hop_reports_once_for_many_callers',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          '\n'
                          'def slow():\n'
                          '    time.sleep(1)\n'
                          '\n'
                          'async def a(request):\n'
                          '    slow()\n'
                          '\n'
                          'async def b(request):\n'
                          '    slow()\n'}},
 {'id': 'gridlint.TestGL4.test_undocumented_metric_fires_GL401',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/OBSERVABILITY.md': '\n'
                                     '# Observability\n'
                                     '| `pygrid_documented_total` | counter | - |\n',
            'pkg/app.py': '\n'
                          'from pygrid_tpu import telemetry\n'
                          '\n'
                          'def serve():\n'
                          '    telemetry.incr("documented_total")\n'
                          '    telemetry.observe("undocumented_seconds", 0.1)\n',
            'pkg/telemetry/bus.py': '\n'
                                    '_FAMILY_HELP = {\n'
                                    '    "documented_total": "a documented family",\n'
                                    '    "undocumented_seconds": "in help but not in docs",\n'
                                    '}\n'}},
 {'id': 'gridlint.TestGL4.test_missing_family_help_fires_GL402',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/OBSERVABILITY.md': '\n'
                                     '# Observability\n'
                                     '| `pygrid_documented_total` | counter | - |\n'
                                     '| `pygrid_orphan_total` | counter | - |\n',
            'pkg/app.py': '\n'
                          'from pygrid_tpu import telemetry\n'
                          '\n'
                          'def serve():\n'
                          '    telemetry.incr("orphan_total")\n',
            'pkg/telemetry/bus.py': '\n'
                                    '_FAMILY_HELP = {\n'
                                    '    "documented_total": "a documented family",\n'
                                    '    "undocumented_seconds": "in help but not in docs",\n'
                                    '}\n'}},
 {'id': 'gridlint.TestGL4.test_wire_constant_duplicate_and_undocumented_fire_GL403',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/WIRE.md': 'tags: 0x01 and 0x02 only\n',
            'pkg/serde/wire.py': '\n'
                                 'EXT_NDARRAY = 0x01\n'
                                 'EXT_OBJECT = 0x02\n'
                                 'EXT_CLASH = 0x01     # duplicate tag byte\n'
                                 'FRAME_SECRET = 0x07  # not in docs/WIRE.md\n'}},
 {'id': 'gridlint.TestGL4.test_subprotocol_string_checked_against_docs',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/WIRE.md': '`pygrid.wire.v2` is the only token. 0x01\n',
            'pkg/serde/wire.py': '\n'
                                 'WS_SUBPROTOCOL_V2 = "pygrid.wire.v2"\n'
                                 'WS_SUBPROTOCOL_V3 = "pygrid.wire.v3"\n'}},
 {'id': 'gridlint.TestGL4.test_GL404_is_superseded_no_module_path_heuristic',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/events.py': '\n'
                                  'def dead_helper(ctx, message, conn):\n'
                                  '    raise ValueError("missing x")\n'}},
 {'id': 'gridlint.TestGL4.test_without_docs_dir_membership_rules_stay_quiet',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'from pygrid_tpu import telemetry\n'
                          '\n'
                          'def serve():\n'
                          '    telemetry.incr("anything_total")\n'}},
 {'id': 'gridlint.TestGL4.test_undocumented_route_path_fires_GL405',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'README.md': 'Endpoints: `/metrics` and `/users/<id>`.\n',
            'pyproject.toml': '[tool.none]\n',
            'docs/OBSERVABILITY.md': 'Also `GET /telemetry/cycles`.\n',
            'pkg/node/routes.py': '\n'
                                  'def register(app):\n'
                                  '    r = app.router\n'
                                  '    r.add_get("/metrics", None)\n'
                                  '    r.add_get("/telemetry/cycles", None)\n'
                                  '    r.add_get("/users/{id}", None)       # <id> form in docs\n'
                                  '    r.add_post("/telemetry/dump", None)  # undocumented\n'
                                  '    r.add_route("*", "/speed-test", None)  # undocumented\n'}},
 {'id': 'gridlint.TestGL4.test_route_paths_outside_route_modules_are_ignored',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'README.md': 'no routes here\n',
            'pyproject.toml': '[tool.none]\n',
            'pkg/examples/demo.py': '\n'
                                    'def register(app):\n'
                                    '    app.router.add_get("/undocumented-but-not-served", '
                                    'None)\n'}},
 {'id': 'gridlint.TestGL4.test_undocumented_ws_event_key_fires_GL406',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/WIRE.md': 'events: `socket-ping`, `model-centric/report`. 0x01\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.utils.codes import EVENTS\n'
                                  '\n'
                                  'ROUTES = {\n'
                                  '    EVENTS.PING: None,\n'
                                  '    EVENTS.REPORT: None,\n'
                                  '    EVENTS.SECRET: None,     # resolved via codes.py\n'
                                  '    "bare-undocumented": None,\n'
                                  '}\n',
            'pkg/utils/codes.py': '\n'
                                  'class EVENTS:\n'
                                  '    PING = "socket-ping"\n'
                                  '    REPORT = "model-centric/report"\n'
                                  '    SECRET = "model-centric/undocumented"\n'}},
 {'id': 'gridlint.TestGL4.test_spread_and_unresolvable_routes_keys_are_skipped',
  'family': 'GL4',
  'families': ['GL4'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/WIRE.md': 'nothing documented. 0x01\n',
            'pkg/node/events.py': '\n'
                                  'from elsewhere import HANDLERS, FOREIGN\n'
                                  '\n'
                                  'ROUTES = {\n'
                                  '    FOREIGN.KEY: None,   # constant not in this tree\n'
                                  '    **HANDLERS,          # spread: no keys to check\n'
                                  '}\n'}},
 {'id': 'gridlint.TestSuppression.test_inline_disable_reports_suppressed',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)  # gridlint: disable=GL202\n'}},
 {'id': 'gridlint.TestSuppression.test_disable_next_line_covers_following_statement',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        # gridlint: disable-next=GL202\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestSuppression.test_disable_family_and_all',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)  # gridlint: disable=GL2\n'}},
 {'id': 'gridlint.TestSuppression.test_disable_family_and_all#2',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)  # gridlint: disable=all\n'}},
 {'id': 'gridlint.TestSuppression.test_skip_file_opts_a_module_out',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '# gridlint: skip-file\n'
                          '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestSuppression.test_unrelated_code_is_not_suppressed',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)  # gridlint: disable=GL301\n'}},
 {'id': 'gridlint.TestBaseline.test_exact_baseline_passes_without_stale',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'baseline.json': '{"version": 1, "entries": [{"path": "pkg/mod.py", "code": "GL202", '
                             '"count": 1, "note": "pre-existing; engine-thread-confined"}]}',
            'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestBaseline.test_stale_baseline_is_reported',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'baseline.json': '{"version": 1, "entries": [{"path": "pkg/mod.py", "code": "GL202", '
                             '"count": 3, "note": "pre-existing; engine-thread-confined"}]}',
            'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestBaseline.test_entry_for_healed_file_is_stale',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'baseline.json': '{"version": 1, "entries": [{"path": "pkg/clean.py", "code": "GL202", '
                             '"count": 2}]}',
            'pyproject.toml': '[tool.none]\n',
            'pkg/clean.py': 'x = 1\n'}},
 {'id': 'gridlint.TestBaseline.test_findings_beyond_allowance_fail',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'baseline.json': '{"version": 1, "entries": [{"path": "pkg/mod.py", "code": "GL202", '
                             '"count": 0, "note": "pre-existing; engine-thread-confined"}]}',
            'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestBaseline.test_baseline_not_stale_when_its_checker_did_not_run',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['other'],
  'exclude': [],
  'files': {'baseline.json': '{"version": 1, "entries": [{"path": "pkg/mod.py", "code": "GL202", '
                             '"count": 1}]}',
            'pyproject.toml': '[tool.none]\n',
            'other/x.py': 'x = 1\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestCLI.test_exit_codes_and_output',
  'family': 'GL2',
  'families': ['GL2', 'GL3', 'GL4', 'GL6', 'GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Store:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._items = []\n'
                          '\n'
                          '    def safe_add(self, x):\n'
                          '        with self._lock:\n'
                          '            self._items.append(x)\n'
                          '\n'
                          '    def racy_add(self, x):\n'
                          '        self._items.append(x)\n'}},
 {'id': 'gridlint.TestCLI.test_exit_codes_and_output#2',
  'family': 'GL2',
  'families': ['GL2', 'GL3', 'GL4', 'GL6', 'GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n', 'pkg/mod.py': 'x = 1\n'}},
 {'id': 'gridlint.TestCLI.test_strict_baseline_fails_on_stale',
  'family': 'GL2',
  'families': ['GL2', 'GL3', 'GL4', 'GL6', 'GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'baseline.json': '{"version": 1, "entries": [{"path": "pkg/clean.py", "code": "GL202", '
                             '"count": 1}]}',
            'pyproject.toml': '[tool.none]\n',
            'pkg/clean.py': 'x = 1\n'}},
 {'id': 'gridlint.TestGL204.test_cross_class_cycle_through_call_graph_fires',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Bus:\n'
                          '    def __init__(self, mgr: "Manager"):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._mgr = mgr\n'
                          '\n'
                          '    def record(self):\n'
                          '        with self._lock:\n'
                          '            self._mgr.poke()\n'
                          '\n'
                          'class Manager:\n'
                          '    def __init__(self, bus: Bus):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._bus = bus\n'
                          '\n'
                          '    def submit(self):\n'
                          '        with self._lock:\n'
                          '            self._bus.record()\n'
                          '\n'
                          '    def poke(self):\n'
                          '        with self._lock:\n'
                          '            pass\n'}},
 {'id': 'gridlint.TestGL204.test_cross_module_cycle_fires',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/bus.py': '\n'
                          'import threading\n'
                          'from pkg.mgr import poke_manager\n'
                          '\n'
                          'class Bus:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def record(self):\n'
                          '        with self._lock:\n'
                          '            poke_manager()\n',
            'pkg/mgr.py': '\n'
                          'import threading\n'
                          'from pkg import bus as bus_mod\n'
                          '\n'
                          '_lock = threading.Lock()\n'
                          '\n'
                          'def poke_manager():\n'
                          '    with _lock:\n'
                          '        pass\n'
                          '\n'
                          'def submit(b):\n'
                          '    with _lock:\n'
                          '        bus_mod.BUS.record()\n'}},
 {'id': 'gridlint.TestGL204.test_cross_module_cycle_fires#2',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/bus.py': '\n'
                          'import threading\n'
                          'from pkg.mgr import poke_manager\n'
                          '\n'
                          'class Bus:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def record(self):\n'
                          '        with self._lock:\n'
                          '            poke_manager()\n'
                          '\n'
                          '\n'
                          'BUS = Bus()\n',
            'pkg/mgr.py': '\n'
                          'import threading\n'
                          'from pkg import bus as bus_mod\n'
                          '\n'
                          '_lock = threading.Lock()\n'
                          '\n'
                          'def poke_manager():\n'
                          '    with _lock:\n'
                          '        pass\n'
                          '\n'
                          'def submit(b):\n'
                          '    with _lock:\n'
                          '        bus_mod.BUS.record()\n'}},
 {'id': 'gridlint.TestGL204.test_consistent_order_is_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Bus:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def record(self):\n'
                          '        with self._lock:\n'
                          '            pass\n'
                          '\n'
                          'class Manager:\n'
                          '    def __init__(self, bus: Bus):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._bus = bus\n'
                          '\n'
                          '    def submit(self):\n'
                          '        with self._lock:\n'
                          '            self._bus.record()\n'
                          '\n'
                          '    def close(self):\n'
                          '        with self._lock:\n'
                          '            self._bus.record()\n'}},
 {'id': 'gridlint.TestGL204.test_one_way_bus_edges_from_many_holders_are_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Bus:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def record(self):\n'
                          '        with self._lock:\n'
                          '            pass\n'
                          '\n'
                          'class A:\n'
                          '    def __init__(self, bus: Bus):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._bus = bus\n'
                          '\n'
                          '    def work(self):\n'
                          '        with self._lock:\n'
                          '            self._bus.record()\n'
                          '\n'
                          'class B:\n'
                          '    def __init__(self, bus: Bus):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._bus = bus\n'
                          '\n'
                          '    def work(self):\n'
                          '        with self._lock:\n'
                          '            self._bus.record()\n'}},
 {'id': 'gridlint.TestGL204.test_single_class_direct_cycle_stays_GL201',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Worker:\n'
                          '    def __init__(self):\n'
                          '        self._a = threading.Lock()\n'
                          '        self._b = threading.Lock()\n'
                          '\n'
                          '    def fwd(self):\n'
                          '        with self._a:\n'
                          '            with self._b:\n'
                          '                pass\n'
                          '\n'
                          '    def rev(self):\n'
                          '        with self._b:\n'
                          '            with self._a:\n'
                          '                pass\n'}},
 {'id': 'gridlint.TestGL204.test_caller_held_sentinel_fabricates_no_edges',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Fold:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._other = threading.Lock()\n'
                          '\n'
                          '    def merge_locked(self):\n'
                          '        with self._other:\n'
                          '            pass\n'
                          '\n'
                          '    def rev(self):\n'
                          '        with self._other:\n'
                          '            with self._lock:\n'
                          '                pass\n'}},
 {'id': 'gridlint.TestGL205.test_blocking_call_under_lock_fires',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          'import time\n'
                          '\n'
                          'class Worker:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def run(self):\n'
                          '        with self._lock:\n'
                          '            time.sleep(1)\n'}},
 {'id': 'gridlint.TestGL205.test_heavy_serde_one_hop_down_fires_at_the_heavy_line',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'def pack(blob):\n'
                          '    return serialize(blob)\n'
                          '\n'
                          'class Manager:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def store(self, blob):\n'
                          '        with self._lock:\n'
                          '            return pack(blob)\n'}},
 {'id': 'gridlint.TestGL205.test_cross_module_hold_reaches_foreign_blocking_line',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/codec.py': '\ndef heavy(blob):\n    return deserialize(blob)\n',
            'pkg/mgr.py': '\n'
                          'import threading\n'
                          'from pkg.codec import heavy\n'
                          '\n'
                          'class Manager:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def load(self, blob):\n'
                          '        with self._lock:\n'
                          '            return heavy(blob)\n'}},
 {'id': 'gridlint.TestGL205.test_event_loop_domain_weights_the_message',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Handler:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    async def handle(self, msg):\n'
                          '        with self._lock:\n'
                          '            return deserialize(msg)\n'}},
 {'id': 'gridlint.TestGL205.test_caller_holds_lock_convention_counts_as_held',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          'import time\n'
                          '\n'
                          'class Fold:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def drain_locked(self):\n'
                          '        time.sleep(0.5)\n'}},
 {'id': 'gridlint.TestGL205.test_blocking_outside_the_lock_is_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          'import time\n'
                          '\n'
                          'class Worker:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def run(self):\n'
                          '        with self._lock:\n'
                          '            n = 1\n'
                          '        time.sleep(n)\n'}},
 {'id': 'gridlint.TestGL205.test_condition_wait_under_lock_is_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Engine:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._work = threading.Condition(self._lock)\n'
                          '\n'
                          '    def loop(self):\n'
                          '        with self._work:\n'
                          '            self._work.wait()\n'}},
 {'id': 'gridlint.TestGL205.test_two_holders_of_one_heavy_line_report_once',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'def pack(blob):\n'
                          '    return serialize(blob)\n'
                          '\n'
                          'class Manager:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._other = threading.Lock()\n'
                          '\n'
                          '    def store(self, blob):\n'
                          '        with self._lock:\n'
                          '            return pack(blob)\n'
                          '\n'
                          '    def restore(self, blob):\n'
                          '        with self._other:\n'
                          '            return pack(blob)\n'}},
 {'id': 'gridlint.TestGL206.test_loop_and_thread_writers_with_no_lock_fire',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Stats:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._thread = threading.Thread(target=self._run)\n'
                          '        self._count = 0\n'
                          '\n'
                          '    def _run(self):\n'
                          '        self._count += 1\n'
                          '\n'
                          '    async def handle(self):\n'
                          '        self._count = 0\n'}},
 {'id': 'gridlint.TestGL206.test_executor_and_loop_writers_fire',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import asyncio\n'
                          '\n'
                          'class Cache:\n'
                          '    def __init__(self):\n'
                          '        self._entries = {}\n'
                          '\n'
                          '    def _refresh(self):\n'
                          '        self._entries = {}\n'
                          '\n'
                          '    async def serve(self, loop, key):\n'
                          '        self._entries[key] = 1\n'
                          '        await loop.run_in_executor(None, self._refresh)\n'}},
 {'id': 'gridlint.TestGL206.test_common_lock_across_domains_is_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Stats:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '        self._thread = threading.Thread(target=self._run)\n'
                          '        self._count = 0\n'
                          '\n'
                          '    def _run(self):\n'
                          '        with self._lock:\n'
                          '            self._count += 1\n'
                          '\n'
                          '    async def handle(self):\n'
                          '        with self._lock:\n'
                          '            self._count = 0\n'}},
 {'id': 'gridlint.TestGL206.test_single_domain_writers_are_quiet',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Pool:\n'
                          '    def __init__(self):\n'
                          '        self._n = 0\n'
                          '        self._a = threading.Thread(target=self._grow, daemon=True)\n'
                          '        self._b = threading.Thread(target=self._grow, daemon=True)\n'
                          '\n'
                          '    def _grow(self):\n'
                          '        self._n += 1\n'}},
 {'id': 'gridlint.TestGL206.test_unreached_methods_fabricate_no_races',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'class Plain:\n'
                          '    def __init__(self):\n'
                          '        self._x = 0\n'
                          '\n'
                          '    def a(self):\n'
                          '        self._x = 1\n'
                          '\n'
                          '    def b(self):\n'
                          '        self._x = 2\n'}},
 {'id': 'gridlint.TestGL206.test_init_writes_do_not_count',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Snapshotter:\n'
                          '    def __init__(self):\n'
                          '        self._last = None\n'
                          '        self._thread = threading.Thread(\n'
                          '            target=self._run, daemon=True\n'
                          '        )\n'
                          '\n'
                          '    def _run(self):\n'
                          '        self._last = {}\n'}},
 {'id': 'gridlint.TestGL206.test_disjoint_locks_across_domains_fire',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Split:\n'
                          '    def __init__(self):\n'
                          '        self._a = threading.Lock()\n'
                          '        self._b = threading.Lock()\n'
                          '        self._state = 0\n'
                          '        self._thread = threading.Thread(target=self._run)\n'
                          '\n'
                          '    def _run(self):\n'
                          '        with self._a:\n'
                          '            self._state += 1\n'
                          '\n'
                          '    async def handle(self):\n'
                          '        with self._b:\n'
                          '            self._state = 0\n'}},
 {'id': 'gridlint.TestGL304NestedDefHop.test_nested_def_called_directly_fires',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          '\n'
                          'async def handler():\n'
                          '    def helper():\n'
                          '        time.sleep(1)\n'
                          '    helper()\n'}},
 {'id': 'gridlint.TestGL304NestedDefHop.test_nested_def_only_referenced_stays_exempt',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import asyncio\n'
                          'import time\n'
                          '\n'
                          'async def handler():\n'
                          '    def helper():\n'
                          '        time.sleep(1)\n'
                          '    loop = asyncio.get_running_loop()\n'
                          '    await loop.run_in_executor(None, helper)\n'}},
 {'id': 'gridlint.TestGL304NestedDefHop.test_nested_def_shadows_module_helper',
  'family': 'GL3',
  'families': ['GL3'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/mod.py': '\n'
                          'import time\n'
                          '\n'
                          'def helper():\n'
                          '    pass\n'
                          '\n'
                          'async def handler():\n'
                          '    def helper():\n'
                          '        time.sleep(1)\n'
                          '    helper()\n'}},
 {'id': 'gridlint.TestCLIChangedAndGithub.test_changed_mode_analyzes_changed_files_and_dependents',
  'family': 'GL2',
  'families': ['GL2', 'GL3', 'GL4', 'GL6', 'GL7'],
  'targets': ['pkg/base.py', 'pkg/dep.py'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/base.py': 'x = 2\n\nasync def handler(msg):\n    return deserialize(msg)\n',
            'pkg/dep.py': 'from pkg.base import x\n'
                          '\n'
                          'async def handler(msg):\n'
                          '    return deserialize(msg)\n',
            'pkg/unrelated.py': '\nasync def handler(msg):\n    return deserialize(msg)\n'}},
 {'id': 'gridlint.TestCLIChangedAndGithub.test_changed_mode_analyzes_changed_files_and_dependents#2',
  'family': 'GL2',
  'families': ['GL2', 'GL3', 'GL4', 'GL6', 'GL7'],
  'targets': ['pkg/base.py', 'pkg/dep.py'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/base.py': 'x = 2\n\nasync def handler(msg):\n    return deserialize(msg)\n',
            'pkg/dep.py': 'from pkg.base import x  # touched\n'
                          '\n'
                          'async def handler(msg):\n'
                          '    return deserialize(msg)\n',
            'pkg/unrelated.py': '\nasync def handler(msg):\n    return deserialize(msg)\n'}},
 {'id': 'gridconc.TestResolution.test_bound_method_reexport_chain_resolves',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': 'from pkg.bus import incr\n',
            'pkg/bus.py': '\n'
                          'import threading\n'
                          '\n'
                          'class Bus:\n'
                          '    def __init__(self):\n'
                          '        self._lock = threading.Lock()\n'
                          '\n'
                          '    def incr(self, name):\n'
                          '        with self._lock:\n'
                          '            pass\n'
                          '\n'
                          'BUS = Bus()\n'
                          'incr = BUS.incr\n',
            'pkg/mgr.py': '\nimport pkg\n\ndef work():\n    pkg.incr("x")\n'}},
 {'id': 'gridconc.TestResolution.test_typed_collaborator_attr_call_resolves',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/bus.py': '\nclass Bus:\n    def record(self):\n        pass\n',
            'pkg/mgr.py': '\n'
                          'from pkg.bus import Bus\n'
                          '\n'
                          'class Manager:\n'
                          '    def __init__(self, bus: Bus):\n'
                          '        self._bus = bus\n'
                          '\n'
                          '    def note(self):\n'
                          '        self._bus.record()\n'}},
 {'id': 'gridconc.TestResolution.test_constructed_attr_type_resolves',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/engine.py': '\n'
                             'from pkg import pool as pagedkv\n'
                             '\n'
                             'class Engine:\n'
                             '    def __init__(self, n):\n'
                             '        self._pool = pagedkv.BlockPool(n)\n'
                             '\n'
                             '    def free(self, pages):\n'
                             '        self._pool.release(pages)\n',
            'pkg/pool.py': '\nclass BlockPool:\n    def release(self, pages):\n        pass\n'}},
 {'id': 'gridconc.TestLockAliasing.test_local_alias_resolves_in_the_graph',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import threading\n'
                        '\n'
                        'class Box:\n'
                        '    def __init__(self):\n'
                        '        self._lock = threading.Lock()\n'
                        '\n'
                        '    def work(self):\n'
                        '        lock = self._lock\n'
                        '        with lock:\n'
                        '            pass\n'}},
 {'id': 'gridconc.TestLockAliasing.test_gl205_fires_through_a_local_alias',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import threading\n'
                        '\n'
                        'class Box:\n'
                        '    def __init__(self):\n'
                        '        self._lock = threading.Lock()\n'
                        '\n'
                        '    def work(self, blob):\n'
                        '        lock = self._lock\n'
                        '        with lock:\n'
                        '            serialize(blob)\n'
                        '\n'
                        'def serialize(blob):\n'
                        '    return blob\n'}},
 {'id': 'gridconc.TestLockAliasing.test_gl202_mutation_under_aliased_lock_counts_as_guarded',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import threading\n'
                        '\n'
                        'class Box:\n'
                        '    def __init__(self):\n'
                        '        self._lock = threading.Lock()\n'
                        '        self._n = 0\n'
                        '\n'
                        '    def locked_incr(self):\n'
                        '        lock = self._lock\n'
                        '        with lock:\n'
                        '            self._n += 1\n'
                        '\n'
                        '    def raced_incr(self):\n'
                        '        self._n += 1\n'}},
 {'id': 'gridconc.TestLockAliasing.test_rebound_alias_is_discarded',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import threading\n'
                        '\n'
                        'class Box:\n'
                        '    def __init__(self):\n'
                        '        self._lock = threading.Lock()\n'
                        '        self._n = 0\n'
                        '\n'
                        '    def work(self, other):\n'
                        '        lock = self._lock\n'
                        '        lock = other\n'
                        '        with lock:\n'
                        '            self._n += 1\n'
                        '\n'
                        '    def raw(self):\n'
                        '        self._n += 1\n'}},
 {'id': 'gridconc.TestLockAliasing.test_tuple_and_for_rebinds_also_discard_the_alias',
  'family': 'GL2',
  'families': ['GL2'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import threading\n'
                        '\n'
                        'class Box:\n'
                        '    def __init__(self):\n'
                        '        self._lock = threading.Lock()\n'
                        '        self._n = 0\n'
                        '\n'
                        '    def unpacked(self, pair):\n'
                        '        lock = self._lock\n'
                        '        lock, other = pair\n'
                        '        with lock:\n'
                        '            self._n += 1\n'
                        '\n'
                        '    def looped(self, locks):\n'
                        '        lock = self._lock\n'
                        '        for lock in locks:\n'
                        '            with lock:\n'
                        '                self._n += 1\n'
                        '\n'
                        '    def raw(self):\n'
                        '        self._n += 1\n'}},
 {'id': 'gridconc.TestInheritance.test_inherited_method_call_edge_resolves',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/base.py': '\n'
                           'class Handler:\n'
                           '    def _decode(self, frame):\n'
                           '        return frame\n',
            'pkg/sub.py': '\n'
                          'from pkg.base import Handler\n'
                          '\n'
                          'class WsHandler(Handler):\n'
                          '    def on_frame(self, frame):\n'
                          '        return self._decode(frame)\n'}},
 {'id': 'gridconc.TestInheritance.test_base_lock_canonicalizes_to_the_defining_class',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/base.py': '\n'
                           'import threading\n'
                           '\n'
                           'class Service:\n'
                           '    def __init__(self):\n'
                           '        self._lock = threading.Lock()\n',
            'pkg/sub.py': '\n'
                          'from pkg.base import Service\n'
                          '\n'
                          'class Engine(Service):\n'
                          '    def work(self):\n'
                          '        with self._lock:\n'
                          '            pass\n'}},
 {'id': 'gridconc.TestInheritance.test_domains_propagate_into_inherited_methods',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/__init__.py': '',
            'pkg/base.py': '\n'
                           'class Handler:\n'
                           '    def _decode(self, frame):\n'
                           '        return frame\n',
            'pkg/sub.py': '\n'
                          'from pkg.base import Handler\n'
                          '\n'
                          'class WsHandler(Handler):\n'
                          '    async def on_frame(self, frame):\n'
                          '        return self._decode(frame)\n'}},
 {'id': 'gridconc.TestDomains.test_entry_points_and_propagation',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/app.py': '\n'
                          'import threading\n'
                          '\n'
                          'def helper():\n'
                          '    pass\n'
                          '\n'
                          'async def route(loop):\n'
                          '    helper()\n'
                          '    await loop.run_in_executor(None, offloaded)\n'
                          '\n'
                          'def offloaded():\n'
                          '    pass\n'
                          '\n'
                          'def never_called():\n'
                          '    pass\n'
                          '\n'
                          'class Engine:\n'
                          '    def start(self):\n'
                          '        self._t = threading.Thread(target=self._run)\n'
                          '        self._s = threading.Thread(\n'
                          '            target=self._snap, daemon=True\n'
                          '        )\n'
                          '\n'
                          '    def _run(self):\n'
                          '        helper()\n'
                          '\n'
                          '    def _snap(self):\n'
                          '        pass\n'}},
 {'id': 'gridconc.TestDomains.test_async_callee_of_a_thread_stays_loop',
  'family': 'GL2',
  'families': [],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/app.py': '\n'
                          'import threading\n'
                          '\n'
                          'async def coro():\n'
                          '    pass\n'
                          '\n'
                          'class Engine:\n'
                          '    def start(self):\n'
                          '        self._t = threading.Thread(target=self._run)\n'
                          '\n'
                          '    def _run(self):\n'
                          '        coro()\n'}},
 {'id': 'gridflow.TestPropagation.test_through_returns_and_call_hop',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'def _describe(report):\n'
                        '    return f"report={report}"\n'
                        '\n'
                        'async def handler(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info(_describe(body))\n'}},
 {'id': 'gridflow.TestPropagation.test_through_percent_and_format',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'async def h1(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info("r=%s" % body)\n'
                        '\n'
                        'async def h2(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info("r={}".format(body))\n'}},
 {'id': 'gridflow.TestPropagation.test_through_container_literals',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'async def h1(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info({"req": body})\n'
                        '\n'
                        'async def h2(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info([body, "tail"])\n'}},
 {'id': 'gridflow.TestPropagation.test_through_attribute_stores',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'class Cache:\n'
                        '    async def put(self, request):\n'
                        '        self._last = await request.json()\n'
                        '\n'
                        '    def describe(self):\n'
                        '        logger.info(self._last)\n'}},
 {'id': 'gridflow.TestPropagation.test_param_stored_to_field_by_callee',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'class Box:\n'
                        '    def store(self, v):\n'
                        '        self._x = v\n'
                        '\n'
                        '    def dump(self):\n'
                        '        logger.info(self._x)\n'
                        '\n'
                        'BOX = Box()\n'
                        '\n'
                        'def track(msg):\n'
                        '    BOX.store(msg["request_key"])\n'}},
 {'id': 'gridflow.TestPropagation.test_param_stored_to_field_sanitized_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'import hashlib\n'
                        '\n'
                        'class Box:\n'
                        '    def store(self, v):\n'
                        '        self._x = v\n'
                        '\n'
                        '    def dump(self):\n'
                        '        logger.info(self._x)\n'
                        '\n'
                        'BOX = Box()\n'
                        '\n'
                        'def track(msg):\n'
                        '    key = msg["request_key"]\n'
                        '    BOX.store(hashlib.sha256(key.encode()).hexdigest())\n'}},
 {'id': 'gridflow.TestPropagation.test_sanitizers_kill_the_flow',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'import hashlib\n'
                        '\n'
                        'def redact(v):\n'
                        '    return "[redacted]"\n'
                        '\n'
                        'async def handler(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info("got %d bytes", len(body))\n'
                        '    logger.info(redact(body))\n'
                        '    logger.info(hashlib.sha256(body).hexdigest())\n'}},
 {'id': 'gridflow.TestPropagation.test_unknown_call_result_does_not_inherit_arg_taint',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'import requests\n'
                        '\n'
                        'def check(request_key):\n'
                        '    resp = requests.head("http://x", headers={"k": request_key})\n'
                        '    logger.info(resp.status_code)\n'}},
 {'id': 'gridflow.TestGL601.test_payload_into_recorder_note_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'from pkg import recorder\n'
                        '\n'
                        'async def handler(request):\n'
                        '    body = await request.json()\n'
                        '    recorder.note("report", detail=body)\n',
            'pkg/recorder.py': '\ndef note(kind, **fields):\n    pass\n'}},
 {'id': 'gridflow.TestGL601.test_length_marker_note_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'from pkg import recorder\n'
                        '\n'
                        'async def handler(request):\n'
                        '    body = await request.json()\n'
                        '    recorder.note("report", size=len(body))\n',
            'pkg/recorder.py': '\ndef note(kind, **fields):\n    pass\n'}},
 {'id': 'gridflow.TestGL601.test_checkpoint_bytes_into_telemetry_field_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'from pkg import telemetry\n'
                        '\n'
                        'def publish(mgr):\n'
                        '    blob = load_encoded("m1")\n'
                        '    telemetry.record("model_hosted", blob=blob)\n'
                        '\n'
                        'def load_encoded(mid):\n'
                        '    return b"weights"\n',
            'pkg/telemetry.py': '\ndef record(event, **fields):\n    pass\n'}},
 {'id': 'gridflow.TestGL602.test_credential_field_into_metric_label_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'from pkg import telemetry\n'
                        '\n'
                        'def track(msg):\n'
                        '    key = msg["request_key"]\n'
                        '    telemetry.incr("reports_total", worker=key)\n',
            'pkg/telemetry.py': '\ndef incr(name, value=1, **labels):\n    pass\n'}},
 {'id': 'gridflow.TestGL602.test_credential_into_exception_message_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'def check(msg):\n'
                        '    token = msg.get("auth_token")\n'
                        '    raise PermissionError(f"bad token {token}")\n'}},
 {'id': 'gridflow.TestGL602.test_note_under_redact_keyed_field_is_sanctioned',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'from pkg import recorder\n'
                        '\n'
                        'def good(msg):\n'
                        '    recorder.note("auth", request_key=msg["request_key"])\n'
                        '\n'
                        'def bad(msg):\n'
                        '    recorder.note("auth", detail=f"key={msg[\'request_key\']}")\n',
            'pkg/recorder.py': '\ndef note(kind, **fields):\n    pass\n'}},
 {'id': 'gridflow.TestGL602.test_hashed_credential_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': 'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'import hashlib\n'
                        '\n'
                        'def track(msg):\n'
                        '    key = msg["request_key"]\n'
                        '    logger.info(hashlib.sha256(key.encode()).hexdigest())\n'}},
 {'id': 'gridflow.TestGL603.test_alloc_leaked_on_early_return_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'class Engine:\n'
                        '    def grab(self, ok):\n'
                        '        pages = self._pool.alloc(4)\n'
                        '        if pages is None:\n'
                        '            return False\n'
                        '        if not ok:\n'
                        '            return False\n'
                        '        self._pool.release(pages)\n'
                        '        return True\n'}},
 {'id': 'gridflow.TestGL603.test_alloc_leaked_on_exception_path_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'class Engine:\n'
                        '    def grab(self, ok):\n'
                        '        pages = self._pool.alloc(4)\n'
                        '        if not ok:\n'
                        '            raise RuntimeError("mid-assign failure")\n'
                        '        self._pool.release(pages)\n'}},
 {'id': 'gridflow.TestGL603.test_try_finally_release_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'class Engine:\n'
                        '    def grab(self, ok):\n'
                        '        pages = self._pool.alloc(4)\n'
                        '        if pages is None:\n'
                        '            return False\n'
                        '        try:\n'
                        '            if not ok:\n'
                        '                raise RuntimeError("x")\n'
                        '        finally:\n'
                        '            self._pool.release(pages)\n'
                        '        return True\n'}},
 {'id': 'gridflow.TestGL603.test_ownership_transfer_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'class Engine:\n'
                        '    def assign(self, row):\n'
                        '        priv = self._pool.alloc(4)\n'
                        '        if priv is None:\n'
                        '            return False\n'
                        '        row.pages = row.shared + priv\n'
                        '        return True\n'
                        '\n'
                        '    def hand_off(self):\n'
                        '        sock = socket.create_connection(("h", 1))\n'
                        '        self._adopt(sock)\n'}},
 {'id': 'gridflow.TestGL603.test_socket_and_tempfile_leaks_fire',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import socket\n'
                        'import tempfile\n'
                        '\n'
                        'def probe(host):\n'
                        '    sock = socket.create_connection((host, 80))\n'
                        '    return sock.recv(1)\n'
                        '\n'
                        'def scratch(log):\n'
                        '    fd, path = tempfile.mkstemp()\n'
                        '    log.last_scratch = True\n'}},
 {'id': 'gridflow.TestGL603.test_multi_path_leak_reports_the_acquire_once',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import socket\n'
                        '\n'
                        'def probe(host, fast):\n'
                        '    sock = socket.create_connection((host, 80))\n'
                        '    if fast:\n'
                        '        return 1\n'
                        '    return 2\n'}},
 {'id': 'gridflow.TestGL603.test_implicit_raise_through_callee_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'def reshard(table):\n'
                        '    raise ValueError("row count drifted")\n'
                        '\n'
                        'class Engine:\n'
                        '    def grab(self, table):\n'
                        '        pages = self._pool.alloc(4)\n'
                        '        reshard(table)\n'
                        '        self._pool.release(pages)\n'}},
 {'id': 'gridflow.TestGL603.test_implicit_raise_covered_at_call_site_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'def reshard(table):\n'
                        '    raise ValueError("row count drifted")\n'
                        '\n'
                        'class Engine:\n'
                        '    def grab(self, table):\n'
                        '        pages = self._pool.alloc(4)\n'
                        '        try:\n'
                        '            reshard(table)\n'
                        '        except ValueError:\n'
                        '            pass\n'
                        '        self._pool.release(pages)\n'
                        '\n'
                        '    def grab_finally(self, table):\n'
                        '        pages = self._pool.alloc(4)\n'
                        '        try:\n'
                        '            reshard(table)\n'
                        '            self._pool.release(pages)\n'
                        '        except ValueError:\n'
                        '            self._pool.release(pages)\n'}},
 {'id': 'gridflow.TestGL603.test_non_with_lock_acquire_must_release',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'class Box:\n'
                        '    def bad(self):\n'
                        '        self._lock.acquire()\n'
                        '        self._n += 1\n'
                        '\n'
                        '    def good(self):\n'
                        '        self._lock.acquire()\n'
                        '        try:\n'
                        '            self._n += 1\n'
                        '        finally:\n'
                        '            self._lock.release()\n'}},
 {'id': 'gridflow.TestGL604.test_untyped_raise_reachable_from_route_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/helpers.py': '\ndef load(request):\n    raise ValueError("bad id")\n',
            'pkg/node/routes.py': '\n'
                                  'from pkg.node import helpers\n'
                                  '\n'
                                  'async def get_model(request):\n'
                                  '    return helpers.load(request)\n'
                                  '\n'
                                  'def setup(r):\n'
                                  '    r.add_get("/model", get_model)\n'}},
 {'id': 'gridflow.TestGL604.test_intervening_catch_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/helpers.py': '\ndef load(request):\n    raise ValueError("bad id")\n',
            'pkg/node/routes.py': '\n'
                                  'from pkg.node import helpers\n'
                                  '\n'
                                  'async def get_model(request):\n'
                                  '    try:\n'
                                  '        return helpers.load(request)\n'
                                  '    except ValueError as err:\n'
                                  '        return {"error": str(err)}\n'
                                  '\n'
                                  'def setup(r):\n'
                                  '    r.add_get("/model", get_model)\n'}},
 {'id': 'gridflow.TestGL604.test_typed_pygrid_error_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/errors.py': '\n'
                             'class PyGridError(Exception):\n'
                             '    pass\n'
                             '\n'
                             'class NotFoundError(PyGridError):\n'
                             '    pass\n'
                             '\n'
                             'class ModelNotFoundError(NotFoundError):\n'
                             '    pass\n',
            'pkg/node/routes.py': '\n'
                                  'from pkg.errors import ModelNotFoundError\n'
                                  '\n'
                                  'async def get_model(request):\n'
                                  '    raise ModelNotFoundError("no such model")\n'
                                  '\n'
                                  'def setup(r):\n'
                                  '    r.add_get("/model", get_model)\n'}},
 {'id': 'gridflow.TestGL604.test_ws_routes_dict_is_an_entry_point',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/events.py': '\n'
                                  'def report(ctx, msg, conn):\n'
                                  '    raise KeyError(msg["id"])\n'
                                  '\n'
                                  'ROUTES = {"model-centric/report": report}\n'}},
 {'id': 'gridflow.TestGL604.test_dict_merged_handler_tables_are_entry_points',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.users.events import USER_HANDLERS\n'
                                  '\n'
                                  'def report(ctx, msg, conn):\n'
                                  '    return {}\n'
                                  '\n'
                                  'ROUTES = {"model-centric/report": report, **USER_HANDLERS}\n',
            'pkg/users/events.py': '\n'
                                   'def signup_user(ctx, msg):\n'
                                   '    raise ValueError("missing email")\n'
                                   '\n'
                                   'USER_HANDLERS = {"user.signup": signup_user}\n'}},
 {'id': 'gridflow.TestGL604.test_factory_wrapped_registration_enters_via_the_factory',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/routes.py': '\n'
                                  'def make_handler(event):\n'
                                  '    if not event:\n'
                                  '        raise ValueError("empty event")\n'
                                  '    async def handler(request):\n'
                                  '        return {}\n'
                                  '    return handler\n'
                                  '\n'
                                  'def setup(r):\n'
                                  '    r.add_post("/users/signup", '
                                  'make_handler("user.signup"))\n'}},
 {'id': 'gridflow.TestGL604.test_annotated_entry_point_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/worker/sub.py': '\n'
                                 'GRIDLINT_ENTRY_POINTS = ("Sub.handle_report", "_dispatch")\n'
                                 '\n'
                                 'class Sub:\n'
                                 '    def handle_report(self, msg):\n'
                                 '        raise KeyError(msg["id"])\n'
                                 '\n'
                                 'def _dispatch(raw):\n'
                                 '    raise ValueError("bad frame")\n'}},
 {'id': 'gridflow.TestGL604.test_annotated_entry_point_typed_raise_is_quiet',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/errors.py': '\n'
                             'class PyGridError(Exception):\n'
                             '    pass\n'
                             '\n'
                             'class BadFrameError(PyGridError):\n'
                             '    pass\n',
            'pkg/worker/sub.py': '\n'
                                 'from pkg.errors import BadFrameError\n'
                                 '\n'
                                 'GRIDLINT_ENTRY_POINTS = ("_dispatch",)\n'
                                 '\n'
                                 'def _dispatch(raw):\n'
                                 '    raise BadFrameError("bad frame")\n'}},
 {'id': 'gridflow.TestGL604.test_catch_of_base_class_covers_subclass_raise',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/node/events.py': '\n'
                                  'def report(ctx, msg, conn):\n'
                                  '    try:\n'
                                  '        _inner(msg)\n'
                                  '    except LookupError:\n'
                                  '        return {"error": "missing"}\n'
                                  '\n'
                                  'def _inner(msg):\n'
                                  '    raise KeyError(msg["id"])\n'
                                  '\n'
                                  'ROUTES = {"model-centric/report": report}\n'}},
 {'id': 'gridflow.TestRepoScale.test_unredacted_dump_twin_fires',
  'family': 'GL6',
  'families': ['GL6'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/rec.py': 'import logging\n'
                          'logger = logging.getLogger(__name__)\n'
                          '\n'
                          'class Recorder:\n'
                          '    async def capture(self, request):\n'
                          '        self._snapshot = await request.json()\n'
                          '\n'
                          '    def dump(self):\n'
                          '        logger.error({"snapshot": self._snapshot})\n'}},
 {'id': 'gridflow.TestCLI.test_explain_prints_the_witness_chain',
  'family': 'GL6',
  'families': ['GL2', 'GL3', 'GL4', 'GL6', 'GL7'],
  'targets': ['pkg'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/a.py': '\n'
                        'import logging\n'
                        'logger = logging.getLogger(__name__)\n'
                        '\n'
                        'def _describe(report):\n'
                        '    return f"report={report}"\n'
                        '\n'
                        'async def handler(request):\n'
                        '    body = await request.json()\n'
                        '    logger.info(_describe(body))\n'}},
 {'id': 'gridproto.TestGL701.test_unregistered_event_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING)\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n'}},
 {'id': 'gridproto.TestGL701.test_registered_event_is_quiet',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING)\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: {"ok": True}}\n'}},
 {'id': 'gridproto.TestGL701.test_literal_spelling_at_send_site_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json("my-ping")\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: {"ok": True}}\n'}},
 {'id': 'gridproto.TestGL701.test_literal_spelling_at_dispatch_site_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING)\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\nROUTES = {"my-ping": lambda message: {"ok": True}}\n'}},
 {'id': 'gridproto.TestGL702.test_dead_handler_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: {"ok": True}}\n'}},
 {'id': 'gridproto.TestGL702.test_spec_receive_only_sanction_is_quiet',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\nversion: 1\nforeign:\n  receive_only: [my-ping]\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: {"ok": True}}\n'}},
 {'id': 'gridproto.TestGL702.test_frame_trace_not_gated_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/wire.py': '\n'
                           'from pkg.frames import encode_frame\n'
                           '\n'
                           'def send(data, tag):\n'
                           '    return encode_frame(data, "zstd", trace=tag)\n'}},
 {'id': 'gridproto.TestGL702.test_gated_trace_and_negotiated_codec_quiet',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/wire.py': '\n'
                           'from pkg.frames import encode_frame\n'
                           '\n'
                           'def send(data, tag, codec, traced):\n'
                           '    t = tag if traced else None\n'
                           '    return encode_frame(data, codec, trace=t)\n'}},
 {'id': 'gridproto.TestGL703.test_consumer_required_key_never_written_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING)\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: message["who"]}\n'}},
 {'id': 'gridproto.TestGL703.test_producer_key_nobody_reads_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(\n'
                             '            FOO_EVENTS.PING, {"who": "me", "junk": 1}\n'
                             '        )\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: '
                                  'message.get("who")}\n'}},
 {'id': 'gridproto.TestGL703.test_matched_required_and_defaulted_keys_quiet',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING, {"who": "me"})\n'
                             '\n'
                             '    def ping_verbose(self):\n'
                             '        return self.ws.send_json(\n'
                             '            FOO_EVENTS.PING, {"who": "me", "extra": 1}\n'
                             '        )\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {\n'
                                  '    FOO_EVENTS.PING:\n'
                                  '        lambda message: (message["who"], '
                                  'message.get("extra")),\n'
                                  '}\n'}},
 {'id': 'gridproto.TestGL703.test_open_producer_set_suppresses_the_check',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self, payload):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING, payload)\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: message["who"]}\n'}},
 {'id': 'gridproto.TestGL704.test_untyped_raise_in_lifecycle_module_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  foo:\n'
                                       '    states:\n'
                                       '      advertise: {}\n'
                                       '      done: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: advertise, via: start}\n'
                                       '      - {from: advertise, to: done, via: finish}\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n'
                                  '\n'
                                  '        def reject():\n'
                                  '            raise ValueError("nope")\n'}},
 {'id': 'gridproto.TestGL704.test_typed_pygriderror_reject_is_quiet',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  foo:\n'
                                       '    states:\n'
                                       '      advertise: {}\n'
                                       '      done: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: advertise, via: start}\n'
                                       '      - {from: advertise, to: done, via: finish}\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n'
                                  '\n'
                                  '        class PyGridError(Exception):\n'
                                  '            pass\n'
                                  '\n'
                                  '        class CycleRejected(PyGridError):\n'
                                  '            pass\n'
                                  '\n'
                                  '        def reject():\n'
                                  '            raise CycleRejected("nope")\n'}},
 {'id': 'gridproto.TestGL704.test_non_terminal_spec_state_without_exit_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  foo:\n'
                                       '    states:\n'
                                       '      advertise: {}\n'
                                       '      stuck: {}\n'
                                       '      done: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: advertise, via: start}\n'
                                       '      - {from: advertise, to: stuck, via: wedge}\n'
                                       '      - {from: advertise, to: done, via: finish}\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n'}},
 {'id': 'gridproto.TestGL705.test_lifecycle_without_committed_spec_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'pkg/manager.py': '\n'
                              'class Manager:\n'
                              '    def __init__(self, db):\n'
                              '        self._cycles = db\n'
                              '\n'
                              '    def create(self):\n'
                              '        self._cycles.register(id=1, is_completed=False)\n'
                              '\n'
                              '    def finish(self):\n'
                              '        self._cycles.modify({"id": 1}, {"is_completed": True})\n'}},
 {'id': 'gridproto.TestGL705.test_code_vs_spec_transition_drift_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  foo:\n'
                                       '    states:\n'
                                       '      advertise: {}\n'
                                       '      done: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: advertise, via: boot}\n'
                                       '      - {from: advertise, to: done, via: finish}\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n'}},
 {'id': 'gridproto.TestGL705.test_machine_missing_from_spec_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  bar:\n'
                                       '    states:\n'
                                       '      open: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: open, via: create}\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n'}},
 {'id': 'gridproto.TestGL705.test_plane_handled_list_drift_fires',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  foo:\n'
                                       '    states:\n'
                                       '      advertise: {}\n'
                                       '      done: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: advertise, via: start}\n'
                                       '      - {from: advertise, to: done, via: finish}\n'
                                       'planes:\n'
                                       '  node:\n'
                                       '    handled: [my-ping, my-echo]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING)\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: {"ok": True}}\n'}},
 {'id': 'gridproto.TestGL705.test_matching_spec_round_trips_clean',
  'family': 'GL7',
  'families': ['GL7'],
  'targets': ['.'],
  'exclude': [],
  'files': {'pyproject.toml': '[tool.none]\n',
            'docs/wire_protocol.yaml': '\n'
                                       'version: 1\n'
                                       'lifecycle:\n'
                                       '  foo:\n'
                                       '    states:\n'
                                       '      advertise: {}\n'
                                       '      done: {terminal: true}\n'
                                       '    transitions:\n'
                                       '      - {from: start, to: advertise, via: start}\n'
                                       '      - {from: advertise, to: done, via: finish}\n'
                                       'planes:\n'
                                       '  node:\n'
                                       '    handled: [my-ping]\n',
            'pkg/client.py': '\n'
                             'from pkg.codes import FOO_EVENTS\n'
                             '\n'
                             'class Client:\n'
                             '    def ping(self):\n'
                             '        return self.ws.send_json(FOO_EVENTS.PING, {"who": "me"})\n',
            'pkg/codes.py': '\nclass FOO_EVENTS:\n    PING = "my-ping"\n    ECHO = "my-echo"\n',
            'pkg/foo_service.py': '\n'
                                  'ADVERTISE, DONE = ("advertise", "done")\n'
                                  '\n'
                                  'class FooService:\n'
                                  '    def start(self):\n'
                                  '        self.phase = ADVERTISE\n'
                                  '\n'
                                  '    def finish(self):\n'
                                  '        self.phase = DONE\n',
            'pkg/node/events.py': '\n'
                                  'from pkg.codes import FOO_EVENTS\n'
                                  '\n'
                                  'ROUTES = {FOO_EVENTS.PING: lambda message: message["who"]}\n'}}]
