from .collate import BatchFeed, bucket_length, pad_batch
from .dataset import VideoDataset, exclude_label
from .sampler import BucketBatchSampler
