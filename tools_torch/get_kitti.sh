#!/bin/bash
# Download KITTI 3D object detection data and build COCO-format annotations
# with the port's converter (the steps of tools_tpu/get_kitti.sh;
# reference tools/get_kitti.sh). Needs network access and a KITTI
# account. Run from the repository's root.
set -e
mkdir -p data/kitti && cd data/kitti

wget https://s3.eu-central-1.amazonaws.com/avg-kitti/data_object_image_2.zip
wget https://s3.eu-central-1.amazonaws.com/avg-kitti/data_object_label_2.zip
wget https://s3.eu-central-1.amazonaws.com/avg-kitti/data_object_calib.zip
unzip data_object_image_2.zip && unzip data_object_label_2.zip \
    && unzip data_object_calib.zip
mkdir -p images && ln -sf ../training/image_2 images/trainval

cd ../..
# 3DOP split files ship with the reference paper's release; given
# train.txt/val.txt under data/kitti/:
python tools_torch/convert_kitti_to_coco.py --kitti_dir data/kitti \
  --split_file data/kitti/train.txt \
  --out data/kitti/annotations/kitti_3dop_train.json
python tools_torch/convert_kitti_to_coco.py --kitti_dir data/kitti \
  --split_file data/kitti/val.txt \
  --out data/kitti/annotations/kitti_3dop_val.json
