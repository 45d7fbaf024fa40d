"""The port's gin-compatible configuration system (its own registry).

Import as ``from tensor2robot_tpu_torch import config as gin`` for
reference-style ``@gin.configurable`` / ``gin.parse_config_files_and_bindings``.
The JAX package's registry is a different one: parsing a config here
never binds or replaces a JAX configurable, and the other way round.
"""

from tensor2robot_tpu_torch.config.ginlite import (
    GinError,
    REQUIRED,
    add_config_file_search_path,
    bind_parameter,
    clear_config,
    config_scope,
    config_str,
    configurable,
    external_configurable,
    operative_config_str,
    parse_config,
    parse_config_file,
    parse_config_files_and_bindings,
    parse_value,
    query_parameter,
    register_lazy_configurables,
    resolve_config_path,
    split_statements,
)
