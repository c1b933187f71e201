"""Declarative per-language configuration registry.

Parity target: reference `src/lattice/parsing/language_config.py:26-352` —
a `LanguageConfig` record per language (9 configs: Python, JS, JSX, TS,
TSX, Rust, Java, Go, C++), a registry + extension map + lookup helpers, and
an `FQNConfig` describing how qualified names are formed. As in the
reference, only the Python/JS/TS variants are wired into extractors; the
Rust/Java/Go/C++ configs serve the call-resolution and builtin paths
(`language_config.py` note in SURVEY §2 #9).

The reference's configs carry tree-sitter node-type names; without
tree-sitter the equivalent declarative surface here is the lexical facts
the extractors and the call cascade consult: comment/doc syntax, call
separators, import styles, package indicator files, and FQN joining rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lattice_tpu_torch.core.types import Language


@dataclass(frozen=True)
class FQNConfig:
    """How qualified names are formed. Reference: `language_config.py:84-100`."""

    separator: str = "."
    module_from_path: bool = True       # derive module QN from file path
    drop_leaf_names: tuple[str, ...] = ()   # __init__ / index / mod


@dataclass(frozen=True)
class LanguageConfig:
    """Reference: `language_config.py:26-81`."""

    language: Language
    extensions: tuple[str, ...]
    line_comment: str
    block_comment: tuple[str, str] | None
    doc_comment: str                     # docstring / JSDoc / /// style
    call_separators: tuple[str, ...]
    import_keywords: tuple[str, ...]
    package_indicators: tuple[str, ...]  # files marking a package root
    fqn: FQNConfig = field(default_factory=FQNConfig)
    supports_classes: bool = True
    supports_interfaces: bool = False
    extractor_wired: bool = False        # end-to-end extraction available
    case_convention: str = "snake"       # snake | camel | pascal


LANGUAGE_CONFIGS: dict[Language, LanguageConfig] = {
    Language.PYTHON: LanguageConfig(
        language=Language.PYTHON,
        extensions=(".py", ".pyi"),
        line_comment="#",
        block_comment=None,
        doc_comment='"""',
        call_separators=(".",),
        import_keywords=("import", "from"),
        package_indicators=("__init__.py", "pyproject.toml", "setup.py"),
        fqn=FQNConfig(separator=".", drop_leaf_names=("__init__",)),
        extractor_wired=True,
        case_convention="snake",
    ),
    Language.JAVASCRIPT: LanguageConfig(
        language=Language.JAVASCRIPT,
        extensions=(".js", ".mjs", ".cjs"),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="/**",
        call_separators=(".", ".prototype."),
        import_keywords=("import", "require"),
        package_indicators=("package.json",),
        fqn=FQNConfig(separator=".", drop_leaf_names=("index",)),
        extractor_wired=True,
        case_convention="camel",
    ),
    Language.JSX: LanguageConfig(
        language=Language.JSX,
        extensions=(".jsx",),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="/**",
        call_separators=(".", ".prototype."),
        import_keywords=("import", "require"),
        package_indicators=("package.json",),
        fqn=FQNConfig(separator=".", drop_leaf_names=("index",)),
        extractor_wired=True,
        case_convention="camel",
    ),
    Language.TYPESCRIPT: LanguageConfig(
        language=Language.TYPESCRIPT,
        extensions=(".ts", ".mts"),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="/**",
        call_separators=(".",),
        import_keywords=("import", "require", "import type"),
        package_indicators=("package.json", "tsconfig.json"),
        fqn=FQNConfig(separator=".", drop_leaf_names=("index",)),
        supports_interfaces=True,
        extractor_wired=True,
        case_convention="camel",
    ),
    Language.TSX: LanguageConfig(
        language=Language.TSX,
        extensions=(".tsx",),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="/**",
        call_separators=(".",),
        import_keywords=("import", "require", "import type"),
        package_indicators=("package.json", "tsconfig.json"),
        fqn=FQNConfig(separator=".", drop_leaf_names=("index",)),
        supports_interfaces=True,
        extractor_wired=True,
        case_convention="camel",
    ),
    Language.RUST: LanguageConfig(
        language=Language.RUST,
        extensions=(".rs",),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="///",
        call_separators=("::", "."),
        import_keywords=("use", "mod"),
        package_indicators=("Cargo.toml",),
        fqn=FQNConfig(separator="::", drop_leaf_names=("mod",)),
        supports_interfaces=True,   # traits
        case_convention="snake",
    ),
    Language.JAVA: LanguageConfig(
        language=Language.JAVA,
        extensions=(".java",),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="/**",
        call_separators=(".",),
        import_keywords=("import",),
        package_indicators=("pom.xml", "build.gradle"),
        fqn=FQNConfig(separator="."),
        supports_interfaces=True,
        case_convention="camel",
    ),
    Language.GO: LanguageConfig(
        language=Language.GO,
        extensions=(".go",),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="//",
        call_separators=(".",),
        import_keywords=("import",),
        package_indicators=("go.mod",),
        fqn=FQNConfig(separator="."),
        supports_interfaces=True,
        case_convention="camel",
    ),
    Language.CPP: LanguageConfig(
        language=Language.CPP,
        extensions=(".cc", ".cpp", ".cxx", ".h", ".hh", ".hpp"),
        line_comment="//",
        block_comment=("/*", "*/"),
        doc_comment="///",
        call_separators=("::", ".", "->"),
        import_keywords=("#include",),
        package_indicators=("CMakeLists.txt", "Makefile", "BUILD"),
        fqn=FQNConfig(separator="::"),
        case_convention="snake",
    ),
}

EXTENSION_TO_CONFIG: dict[str, LanguageConfig] = {
    ext: cfg for cfg in LANGUAGE_CONFIGS.values() for ext in cfg.extensions
}


def get_language_config(language: Language) -> LanguageConfig | None:
    """Reference: `language_config.py:272-352` lookup helpers."""
    return LANGUAGE_CONFIGS.get(language)


def config_for_extension(ext: str) -> LanguageConfig | None:
    return EXTENSION_TO_CONFIG.get(ext.lower())


def wired_languages() -> list[Language]:
    return [cfg.language for cfg in LANGUAGE_CONFIGS.values()
            if cfg.extractor_wired]
