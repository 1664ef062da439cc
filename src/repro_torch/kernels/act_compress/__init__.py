from repro_torch.kernels.act_compress.kernel import (CODECS, dequantize_rows,
                                                     ef_round_trip_rows,
                                                     quantize_rows)
from repro_torch.kernels.act_compress.ops import (compress, compressed_bytes,
                                                  decompress, ef_compress)
from repro_torch.kernels.act_compress.ref import (dequantize_rows_ref,
                                                  ef_round_trip_rows_ref,
                                                  quantize_rows_ref)

__all__ = ["CODECS", "quantize_rows", "dequantize_rows",
           "ef_round_trip_rows", "compress", "decompress", "compressed_bytes",
           "ef_compress", "quantize_rows_ref", "dequantize_rows_ref",
           "ef_round_trip_rows_ref"]
