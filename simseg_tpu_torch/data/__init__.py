"""Datasets, loaders, tokenizer and transforms (port of ``simseg_tpu/data``).

JAX's public table (``simseg_tpu/data/__init__.py``), each name imported
from its submodule on first use, so ``import simseg_tpu_torch.data`` imports
no submodule (the train transforms need PIL, the nvJPEG decode a build).
Every JAX name has a counterpart.
"""

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.data.{module}", name)
           for module, names in (
               ("corruption", ("process_caption",)),
               ("datasets", ("DATALOADER", "ConcatDataset", "CsvPairDataset",
                             "DataLoader", "ImageFolderDataset",
                             "ParquetRetrievalDataset", "SegDataset",
                             "build_seg_valid_loader", "debias_batches",
                             "sequential_batches")),
               ("tokenizer", ("WordPieceTokenizer", "build_tokenizer",
                              "make_test_vocab")),
               ("transforms", ("TRANSFORMS", "build_transforms",
                               "denormalize_to_u8", "normalize_images")),
           ) for name in names}
__all__ = list(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)
