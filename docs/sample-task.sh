#!/bin/sh
# End-to-end scene processing, mirroring the reference's DOC/sample-task.sh
# 4-step flow with the oiptpu CLI.  Adjust paths/params per scene.
set -e

AOS=KASHI_TJ3-01_20220817_031259_1.dat
STEM=KASHI_TJ3-01_CMOS-1_20220817_031259

# 1) separate downlink into AUX telemetry + PAN/MSS rasters
oiptpu auxsep "$AOS"

# 2) (per CMOS pair) stitch-parameter calc + RRC + PAN2 pixel correction
oiptpu prestitch \
    --pan1 CMOS1.PAN.RAW --pan2 CMOS2.PAN.RAW \
    --rrc1 rrc_pan1.txt  --rrc2 rrc_pan2.txt \
    -s 10 -l 16000 --stitch-overlap 200

# 3) inter-band registration + alignment (default command)
oiptpu \
    --pan "$STEM.PAN.RAW" --mss "$STEM.MSS.RAW" \
    --do-rrc4pan --rrc-pan rrc_pan.txt \
    --rrc-msb1 rrc_b1.txt --rrc-msb2 rrc_b2.txt \
    --rrc-msb3 rrc_b3.txt --rrc-msb4 rrc_b4.txt

# 4) stitch the two CMOS halves (RAW path; band-mapped BigTIFF path below)
# fold columns pair with the prestitch overlap (reference sample-task:
# FOLDCOL_PAN = stitch-overlap = 200; FOLDCOL_MSS = 200/4 = 50)
oiptpu stitch --image1 CMOS1.PAN.RRC.RAW --image2 CMOS2.PAN.RRC.PRESTT.RAW \
    -o FULL.PAN.STT.RAW -c 200
# oiptpu stitch --image1 L.ALIGNED.TIFF --image2 R.ALIGNED.TIFF \
#     -o FULL.MSS.TIFF -c 50 -g -m 3,2,1,4

# --- or: the whole scene in fused device programs (fast mode, one run) ---
# oiptpu scene \
#     --pan1 CMOS1.PAN.RAW --pan2 CMOS2.PAN.RAW \
#     --mss CMOS1.MSS.RAW  --mss2 CMOS2.MSS.RAW \
#     --rrc-pan1 rrc_pan1.txt --rrc-pan2 rrc_pan2.txt \
#     --rrc-msb1 rrc_b1.txt --rrc-msb2 rrc_b2.txt \
#     --rrc-msb3 rrc_b3.txt --rrc-msb4 rrc_b4.txt \
#     --rrc-m2b1 rrc2_b1.txt --rrc-m2b2 rrc2_b2.txt \
#     --rrc-m2b3 rrc2_b3.txt --rrc-m2b4 rrc2_b4.txt \
#     -c 200 -o FULL.PAN.STT.TIFF --out-mss FULL.MSS.TIFF

# --- or: SPMD over an N-chip mesh (align, prestitch AND scene) ---
# oiptpu prestitch --mesh 8 ...
# oiptpu --mesh 8 --pan ... --mss ...
# oiptpu scene --mesh 8 --pan1 ... --pan2 ... --mss ...

# --- or: scenes larger than device memory, streamed in sections
#         (bit-identical outputs to the resident scene run) ---
# oiptpu scene --stream --pan1 ... --pan2 ... --mss ...
