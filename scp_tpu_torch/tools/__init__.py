"""Tools of the port: the test-data and shard CLIs (test_gene, psnr_test,
preprocess, multi_preproc, gene_normals), the bench-checkpoint training
recipe and probes that measure on the card."""
