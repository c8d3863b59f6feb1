from manga_ocr_tpu_torch.engine.engine import TorchMangaOcrEngine

__all__ = ["TorchMangaOcrEngine"]
