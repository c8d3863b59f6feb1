from manga_ocr_tpu_torch.typeset.area import TypesetArea
