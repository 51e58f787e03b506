"""Device-mesh parallelism: batched problem solves over accelerator meshes."""
