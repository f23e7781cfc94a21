#!/bin/bash
# Download Pascal VOC 07+12 and the COCO-format annotations, then merge
# trainval with the port's merge tool (the steps of tools_tpu/
# get_pascal_voc.sh; reference tools/get_pascal_voc.sh). Needs network
# access. Run from the repository's root.
set -e
mkdir -p data/voc && cd data/voc

wget http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCtrainval_11-May-2012.tar
wget http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtrainval_06-Nov-2007.tar
wget http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtest_06-Nov-2007.tar
tar xf VOCtrainval_11-May-2012.tar && tar xf VOCtrainval_06-Nov-2007.tar \
    && tar xf VOCtest_06-Nov-2007.tar

# COCO-format annotations (PASCAL_VOC.zip from the detectron conversion)
wget https://storage.googleapis.com/coco-dataset/external/PASCAL_VOC.zip
unzip PASCAL_VOC.zip -d annotations_raw
mkdir -p annotations images
mv annotations_raw/PASCAL_VOC/*.json annotations/

# flatten images
for d in VOCdevkit/VOC2007/JPEGImages VOCdevkit/VOC2012/JPEGImages; do
  cp -r $d/* images/
done

cd ../..
python tools_torch/merge_pascal_json.py \
  data/voc/annotations/pascal_train2007.json \
  data/voc/annotations/pascal_val2007.json \
  data/voc/annotations/pascal_train2012.json \
  data/voc/annotations/pascal_val2012.json \
  --out data/voc/annotations/pascal_trainval0712.json
