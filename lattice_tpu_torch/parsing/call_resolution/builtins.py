"""Builtin-name tables used by the call-resolution cascade.

Parity target: reference `src/lattice/parsing/call_resolution/builtins.py:3-85`
(Python builtin callables, JS builtin types/patterns, Function-prototype
suffixes, IIFE prefixes, call separators, C++ operator map, Rust/Java
keywords). Tables are authored fresh from language knowledge.
"""

from __future__ import annotations

PYTHON_BUILTINS: frozenset[str] = frozenset({
    "abs", "aiter", "all", "anext", "any", "ascii", "bin", "bool",
    "bytearray", "bytes", "callable", "chr", "classmethod", "compile",
    "complex", "delattr", "dict", "dir", "divmod", "enumerate", "eval",
    "exec", "filter", "float", "format", "frozenset", "getattr", "globals",
    "hasattr", "hash", "hex", "id", "input", "int", "isinstance",
    "issubclass", "iter", "len", "list", "locals", "map", "max", "min",
    "next", "object", "oct", "open", "ord", "pow", "print", "property",
    "range", "repr", "reversed", "round", "set", "setattr", "slice",
    "sorted", "staticmethod", "str", "sum", "super", "tuple", "type",
    "vars", "zip", "__import__",
    # builtin exception constructors are calls too
    "ValueError", "TypeError", "KeyError", "IndexError", "RuntimeError",
    "AttributeError", "NotImplementedError", "StopIteration", "OSError",
    "IOError", "FileNotFoundError", "PermissionError", "TimeoutError",
    "ConnectionError", "Exception", "BaseException", "ZeroDivisionError",
    "OverflowError", "AssertionError", "ImportError", "ModuleNotFoundError",
    "UnicodeDecodeError", "KeyboardInterrupt", "SystemExit", "Warning",
    "DeprecationWarning", "UserWarning",
})

# Top-level stdlib modules whose members resolve as external (no graph
# edge), mirroring how the JS table treats `Math`/`JSON` receivers.
PYTHON_STDLIB_MODULES: frozenset[str] = frozenset({
    "abc", "argparse", "ast", "asyncio", "base64", "bisect", "collections",
    "contextlib", "copy", "csv", "dataclasses", "datetime", "decimal",
    "enum", "errno", "fnmatch", "functools", "glob", "gzip", "hashlib",
    "heapq", "hmac", "html", "http", "importlib", "inspect", "io",
    "itertools", "json", "logging", "math", "multiprocessing", "os",
    "pathlib", "pickle", "platform", "pprint", "queue", "random", "re",
    "secrets", "select", "shlex", "shutil", "signal", "socket", "sqlite3",
    "stat", "string", "struct", "subprocess", "sys", "tempfile",
    "textwrap", "threading", "time", "tomllib", "traceback", "types",
    "typing", "unicodedata", "urllib", "uuid", "warnings", "weakref",
    "xml", "zlib",
})

# Common container/str/path method names that resolve to Python object
# protocols when nothing more specific matched (the analog of
# JS_PROTOTYPE_METHODS; consulted only at the builtin step, after imports /
# receiver types / same-module lookups have all failed).
PYTHON_COMMON_METHODS: frozenset[str] = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "sort",
    "reverse", "copy", "count", "index", "add", "discard", "update",
    "keys", "values", "items", "get", "setdefault", "popitem", "strip",
    "lstrip", "rstrip", "split", "rsplit", "splitlines", "join", "format",
    "replace", "startswith", "endswith", "lower", "upper", "title",
    "encode", "decode", "find", "rfind", "zfill", "ljust", "rjust",
    "read", "write", "readline", "readlines", "close", "flush", "seek",
    "exists", "is_file", "is_dir", "mkdir", "rmdir", "unlink", "resolve",
    "absolute", "relative_to", "glob", "rglob", "read_text", "write_text",
    "read_bytes", "write_bytes", "touch", "stem", "partition",
    "rpartition", "casefold", "isdigit", "isalpha",
})

# `logger = logging.getLogger(__name__)` is a module-level convention the
# import map cannot see; treat these receiver.method shapes as external.
PYTHON_LOGGER_RECEIVERS: frozenset[str] = frozenset({"logger", "log"})
PYTHON_LOGGER_METHODS: frozenset[str] = frozenset({
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "isEnabledFor", "setLevel",
})

JS_BUILTIN_TYPES: frozenset[str] = frozenset({
    "Array", "Object", "String", "Number", "Boolean", "Math", "JSON",
    "Date", "RegExp", "Promise", "Map", "Set", "WeakMap", "WeakSet",
    "Symbol", "Proxy", "Reflect", "Error", "TypeError", "RangeError",
    "console", "window", "document", "globalThis", "Intl", "BigInt",
    "ArrayBuffer", "DataView", "Int8Array", "Uint8Array", "Float32Array",
    "Float64Array", "URL", "URLSearchParams", "FormData", "Headers",
    "Request", "Response", "AbortController", "TextEncoder", "TextDecoder",
})

JS_BUILTIN_FUNCTIONS: frozenset[str] = frozenset({
    "fetch", "setTimeout", "setInterval", "clearTimeout", "clearInterval",
    "parseInt", "parseFloat", "isNaN", "isFinite", "encodeURIComponent",
    "decodeURIComponent", "encodeURI", "decodeURI", "alert", "confirm",
    "prompt", "require", "structuredClone", "queueMicrotask", "btoa", "atob",
})

# Common method suffixes that resolve to builtin prototypes rather than
# user code: `xs.map(...)`, `p.then(...)` etc.
JS_PROTOTYPE_METHODS: frozenset[str] = frozenset({
    "map", "filter", "reduce", "forEach", "find", "findIndex", "some",
    "every", "includes", "indexOf", "push", "pop", "shift", "unshift",
    "slice", "splice", "concat", "join", "sort", "reverse", "flat",
    "flatMap", "keys", "values", "entries", "then", "catch", "finally",
    "toString", "valueOf", "hasOwnProperty", "split", "replace",
    "replaceAll", "trim", "toLowerCase", "toUpperCase", "startsWith",
    "endsWith", "padStart", "padEnd", "charAt", "charCodeAt", "substring",
    "match", "test", "exec", "bind", "call", "apply", "stringify", "parse",
    "assign", "freeze", "log", "warn", "error", "info", "debug",
})

# Function.prototype suffixes (`fn.call`, `fn.apply`, `fn.bind`).
FUNCTION_PROTOTYPE_SUFFIXES: tuple[str, ...] = (".call", ".apply", ".bind")

# IIFE shapes: `(function(){...})()`, `(() => {...})()`.
IIFE_PREFIXES: tuple[str, ...] = ("(function", "(()", "(async")

# Call separators across supported languages.
CALL_SEPARATORS: tuple[str, ...] = (".", "::", ":", ".prototype.")

# C++ operator spellings -> builtin pseudo-QNs.
CPP_OPERATORS: dict[str, str] = {
    "operator+": "cpp.builtin.operator_add",
    "operator-": "cpp.builtin.operator_sub",
    "operator*": "cpp.builtin.operator_mul",
    "operator/": "cpp.builtin.operator_div",
    "operator%": "cpp.builtin.operator_mod",
    "operator==": "cpp.builtin.operator_eq",
    "operator!=": "cpp.builtin.operator_ne",
    "operator<": "cpp.builtin.operator_lt",
    "operator>": "cpp.builtin.operator_gt",
    "operator<=": "cpp.builtin.operator_le",
    "operator>=": "cpp.builtin.operator_ge",
    "operator<<": "cpp.builtin.operator_shl",
    "operator>>": "cpp.builtin.operator_shr",
    "operator[]": "cpp.builtin.operator_index",
    "operator()": "cpp.builtin.operator_call",
    "operator=": "cpp.builtin.operator_assign",
}

RUST_KEYWORDS: frozenset[str] = frozenset({
    "fn", "let", "mut", "impl", "trait", "struct", "enum", "match", "if",
    "else", "loop", "while", "for", "in", "pub", "use", "mod", "crate",
    "self", "Self", "super", "return", "unsafe", "async", "await", "move",
    "dyn", "ref", "where", "type", "const", "static",
})

JAVA_KEYWORDS: frozenset[str] = frozenset({
    "abstract", "assert", "boolean", "break", "byte", "case", "catch",
    "char", "class", "continue", "default", "do", "double", "else", "enum",
    "extends", "final", "finally", "float", "for", "if", "implements",
    "import", "instanceof", "int", "interface", "long", "native", "new",
    "package", "private", "protected", "public", "return", "short",
    "static", "strictfp", "super", "switch", "synchronized", "this",
    "throw", "throws", "transient", "try", "void", "volatile", "while",
})


def python_builtin_qn(name: str) -> str:
    return f"builtins.{name}"


def js_builtin_qn(name: str) -> str:
    return f"js.builtin.{name}"
