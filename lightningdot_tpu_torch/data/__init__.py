"""Host-side data helpers of the port (counterpart of lightningdot_tpu/data):
padding ladders, the WordPiece tokenizer and the ITM collate."""
