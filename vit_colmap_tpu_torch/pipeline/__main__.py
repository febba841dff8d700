from vit_colmap_tpu_torch.pipeline.run_pipeline import main

if __name__ == "__main__":
    main()
