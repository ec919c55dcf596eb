from repro_torch.data.pipeline import (DataPipeline, FileTokenSource,
                                       SyntheticBigramSource, make_pipeline)

__all__ = ["SyntheticBigramSource", "FileTokenSource", "DataPipeline",
           "make_pipeline"]
