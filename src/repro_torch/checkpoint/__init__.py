"""repro_torch.checkpoint — checkpoints on disk in the reference's layout
(`ckpt.save`, `latest_step`, `restore`, `AsyncCheckpointer`)."""
