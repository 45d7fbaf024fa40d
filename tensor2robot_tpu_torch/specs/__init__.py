"""Tensor specifications: declaration, packing, serialization and
spec-driven random data."""

from tensor2robot_tpu_torch.specs.packing import (
    SpecValidationError,
    add_sequence_length,
    as_sequence_specs,
    assert_valid_spec_structure,
    filter_required_flat_tensor_spec_structure,
    flatten_spec_structure,
    pack_flat_sequence_to_spec_structure,
    replace_dtype,
    validate_and_flatten,
    validate_and_pack,
)
from tensor2robot_tpu_torch.specs.random_data import (
    make_random_tensors,
    random_array_for_spec,
)
from tensor2robot_tpu_torch.specs.serialization import (
    ASSET_FILENAME,
    deserialize_assets,
    read_assets,
    serialize_assets,
    spec_from_dict,
    spec_to_dict,
    struct_from_dict,
    struct_to_dict,
    write_assets,
)
from tensor2robot_tpu_torch.specs.tensorspec import (
    PATH_SEP,
    ExtendedTensorSpec,
    TensorSpec,
    TensorSpecStruct,
)

__all__ = [
    "ASSET_FILENAME", "ExtendedTensorSpec", "PATH_SEP", "SpecValidationError",
    "TensorSpec", "TensorSpecStruct", "add_sequence_length",
    "as_sequence_specs", "assert_valid_spec_structure", "deserialize_assets",
    "filter_required_flat_tensor_spec_structure", "flatten_spec_structure",
    "make_random_tensors", "pack_flat_sequence_to_spec_structure",
    "random_array_for_spec", "read_assets", "replace_dtype",
    "serialize_assets", "spec_from_dict", "spec_to_dict", "struct_from_dict",
    "struct_to_dict", "validate_and_flatten", "validate_and_pack",
    "write_assets",
]
