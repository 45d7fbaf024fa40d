"""Export generators (port of `export/`): a trained state → a serving
directory of `torch.export` programs and t2r spec assets."""

from tensor2robot_tpu_torch.export.abstract_export_generator import (
    AbstractExportGenerator,
    check_signature_keys,
    claim_timestamped_export_dir,
    latest_export_dir,
    sanitize_signature_key,
)
from tensor2robot_tpu_torch.export.savedmodel_export_generator import (
    SavedModelExportGenerator,
    create_default_exporters,
    load_signatures,
)

__all__ = ["AbstractExportGenerator", "SavedModelExportGenerator",
           "check_signature_keys", "claim_timestamped_export_dir",
           "create_default_exporters", "latest_export_dir",
           "load_signatures", "sanitize_signature_key"]
