from .pipeline import DataConfig, DataPipeline

__all__ = ["DataConfig", "DataPipeline"]
