"""Tools of the port: the test-data and shard CLIs (test_gene, psnr_test,
preprocess, multi_preproc, gene_normals), the bench-checkpoint training
recipe, the reference-checkpoint importer (import_torch_ckpt), the build
seeder (precompile), and probes that measure on the card (bench,
profile_codec, profile_train) or count work per device (scaling_curve)."""
