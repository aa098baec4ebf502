"""Typed configuration tree with TOML persistence and secret storage.

Rebuild of the reference's config subsystem
(reference: src-tauri/src/modules/config/): `ConfigManager` keeps a
hot-swappable snapshot (the ArcSwap pattern, manager.rs:96-148) with
``update(closure)`` read-modify-write; `UserConfig` is a dataclass tree
persisted as TOML; secrets come from env vars or a 0600 file (the Keychain
analog, secure_storage.rs:18-170). Node/graph configs serialize through the
node registry so graphs are fully config-definable.
"""

from .manager import ConfigManager, default_config_path
from .schema import (
    ApiConfig,
    AudioConfig,
    GraphSpec,
    ObsConfig,
    SessionConfig,
    UserConfig,
    fork_from_spec,
    fork_to_spec,
    graph_from_spec,
    graph_to_spec,
)
from .secrets import ApiKeyStorage, EnvKeyStorage, FileKeyStorage, default_key_storage
from .toml_io import dumps_toml, loads_toml

__all__ = [
    "ApiConfig",
    "AudioConfig",
    "ConfigManager",
    "GraphSpec",
    "ObsConfig",
    "SessionConfig",
    "UserConfig",
    "ApiKeyStorage",
    "EnvKeyStorage",
    "FileKeyStorage",
    "default_key_storage",
    "default_config_path",
    "dumps_toml",
    "loads_toml",
    "fork_from_spec",
    "fork_to_spec",
    "graph_from_spec",
    "graph_to_spec",
]
