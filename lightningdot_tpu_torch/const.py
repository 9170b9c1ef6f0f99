"""Constants of the data path (the port's copy of lightningdot_tpu/const.py:
6-23; reference GLOBAL_VARIABLES.py:1-6, dvl/const.py:1-3)."""

# Faster R-CNN region feature dimension.
IMG_DIM = 2048
# Number of detection classes (soft-label dim) for MRC.
IMG_LABEL_DIM = 1601
# TokenBucketSampler bucket size (GLOBAL_VARIABLES.py:4).
BUCKET_SIZE = 8192
# BERT [CLS] id, the image tower's single text token
# (dvl/data/itm.py:74: `img_input_ids = torch.Tensor([101])`).
IMG_CLS_TOKEN_ID = 101

# Padding ladders: batches are padded up these lengths, so a run sees a
# bounded set of shapes while padding stays fully masked.
TXT_LEN_BUCKETS = (16, 32, 48, 64, 80, 128)
IMG_LEN_BUCKETS = (32, 64, 104)  # num_bb <= 100, +1 CLS token, +3 align
CAP_LEN_BUCKETS = (64, 128, 192, 256)
