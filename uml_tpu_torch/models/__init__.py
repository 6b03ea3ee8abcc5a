"""CLIP ViT and DINO / DINOv2 models, tokenizer, checkpoint reading and
encoder loading."""
