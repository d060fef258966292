from repro_torch.data.pipeline import DataPipeline, LMStreamConfig, TokenStream

__all__ = ["DataPipeline", "LMStreamConfig", "TokenStream"]
